// Exact greedy token cover of 128-position segments, from the step array.
//
// Replaces: compu_tpu/kernels/parse_pallas.py:_parse_kernel and the jump
// targets around it (the whole of parse_cover_pallas). Plain version:
// compu_tpu_torch/kernels/parse_cover.py parse_cover_steps_torch; CPU model
// of this kernel's lanes: parse_cover_lanes_torch.
//
// step[i] (int64) is the greedy parser's advance at position i. In segment
// s, local position i jumps to nl[i] = min(i + clamp(step, 1, 128), 128),
// always forward; the cover is the orbit of local 0: 0, nl[0], nl[nl[0]],
// ... below 128, written as one 0/1 byte a position. The TPU squares a
// one-hot jump matrix 7 times on its matrix unit.
//
// Bound on the H100: bytes. 9 bytes a position (8 in, 1 out) against about
// one warp instruction a position; a serial walk of the orbit (up to 127
// dependent hops, the earlier design) is bound by its chain instead.
//
// Design: one warp a segment, lane l holding the window of positions
// 4l..4l+3, and no serial walk:
// 1. Loads: lane l reads positions 2l, 2l+1 and 64+2l, 65+2l as two 16-byte
//    vectors, so each warp load is 512 contiguous bytes. The clamped steps
//    (<= 128; when every step of the warp is below 2^32, two 32-bit min/max
//    each) are packed one byte each, and two shuffles and a byte permute
//    give each lane its window's four steps; the targets base + o + step
//    (<= 255) are added and clamped at 128 bytewise in one word.
// 2. Local walk: each lane walks its window in registers from each of its
//    four entry offsets o: X[o], the first position past the window that
//    the walk reaches, and M[o], the window positions it marks (a nibble
//    each). The orbit enters a window at most once, so it is a chain of at
//    most 32 states (position, with J(state) = X), one a window.
// 3. Doubling: J_0 = X in a 132-byte shared table per level (byte 128, the
//    sink, holds 128), and J_{k+1} = J_k o J_k by four rounds of byte
//    gathers, each ending in __syncwarp: J_0..J_4 jump 1..16 states. 128
//    bytes span the 32 banks once and no gather reads word 0, so the
//    gathers are free of bank conflicts. The warp index is shuffled from
//    lane 0, so the compiler keeps the tables' base in a uniform register
//    and a gather is one load.
// 4. Orbit: lane l steps to the orbit's state number l, J^l(0), taking J_k
//    in round k when bit k of l is set (so its chain runs beside the
//    doubling), and writes that state's offset as the entry of its window
//    in shared memory; each lane then reads its window's entry (4 if the
//    orbit skips it) and takes the nibble M[entry].
// 5. Stores: one 4-byte word of 0/1 bytes a lane, 128 contiguous bytes a
//    warp.
// The grid is persistent: as many blocks as fit on the card at once, each
// warp striding over the segments and loading the next one before it works
// on this one, so a launch pays for few block dispatches and each SM keeps
// loads in flight while it works.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kWarps = 8;
constexpr int kLevels = 5;   // J_0 .. J_4
constexpr int kTable = 132;  // 128 states, the sink at 128, padded to words
constexpr int kEntry = 36;   // an entry offset a window, and one past the orbit
constexpr int kWarpBytes = kLevels * kTable + kEntry;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t umin(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t umax(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// clamp(s, 1, 128) of four int64 steps, one byte each.
__device__ __forceinline__ uint32_t clamp4(const longlong2 lo, const longlong2 hi) {
  uint32_t c[4];
  const long long s[4] = {lo.x, lo.y, hi.x, hi.y};
  const uint32_t top = static_cast<uint32_t>(s[0] >> 32) | static_cast<uint32_t>(s[1] >> 32) |
                       static_cast<uint32_t>(s[2] >> 32) | static_cast<uint32_t>(s[3] >> 32);
  if (__all_sync(kFull, top == 0)) {  // every step of the warp below 2^32
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = umax(umin(static_cast<uint32_t>(s[i]), kSeg), 1u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = static_cast<uint32_t>(s[i] < 1 ? 1 : (s[i] > kSeg ? kSeg : s[i]));
    }
  }
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

__device__ __forceinline__ uint32_t pack(const uint32_t (&v)[4]) {
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

// This lane's word of the segment's cover. lo, hi: the steps of positions
// 2 lane, 2 lane + 1 and 64 + 2 lane, 65 + 2 lane; tab: this warp's
// kLevels tables, their sinks set; entry: its kEntry bytes.
__device__ __forceinline__ uint32_t cover_word(const longlong2 lo, const longlong2 hi,
                                               const uint32_t lane, uint8_t* tab,
                                               uint8_t* entry) {
  const uint32_t base = 4 * lane;
  const uint32_t held = clamp4(lo, hi);
  const uint32_t a = __shfl_sync(kFull, held, 2 * lane);  // lane 2l mod 32
  const uint32_t b = __shfl_sync(kFull, held, 2 * lane + 1);
  uint32_t t = __byte_perm(a, b, lane < 16 ? 0x5410 : 0x7632);
  t += base * 0x01010101u + 0x03020100u;    // base + o + step <= 255
  t &= ~(((t >> 7) & 0x01010101u) * 0x7Fu);  // min(., 128) a byte

  uint32_t J[4], M[4];
#pragma unroll
  for (int o = 3; o >= 0; --o) {
    const uint32_t to = __byte_perm(t, 0, 0x4440 + o);
    J[o] = to;
    M[o] = 1u << o;
#pragma unroll
    for (int q = o + 1; q < 4; ++q) {
      if (to == base + q) {
        J[o] = J[q];
        M[o] |= M[q];
      }
    }
  }
  const uint32_t marks = M[0] | M[1] << 4 | M[2] << 8 | M[3] << 12;

  entry[lane] = 4;  // the orbit skips this window, unless a lane says otherwise
  *reinterpret_cast<uint32_t*>(tab + base) = pack(J);
  __syncwarp();
  // s: the orbit's state number `lane`, J^lane(0), one bit of lane a round.
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k + 1 < kLevels; ++k) {
    const uint32_t n = tab[k * kTable + s];
    s = (lane >> k) & 1 ? n : s;
#pragma unroll
    for (int o = 0; o < 4; ++o) J[o] = tab[k * kTable + J[o]];
    *reinterpret_cast<uint32_t*>(tab + (k + 1) * kTable + base) = pack(J);
    __syncwarp();
  }
  const uint32_t n = tab[(kLevels - 1) * kTable + s];
  s = lane >> (kLevels - 1) ? n : s;
  entry[s >> 2] = s & 3;  // s = 128, past the orbit's end, writes entry[32]
  __syncwarp();
  const uint32_t e = entry[lane];
  __syncwarp();  // every lane is done with the tables
  return (((marks >> (4 * e)) & 0xF) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kWarps * 32)
    parse_cover_kernel(const longlong2* __restrict__ step, uint32_t* __restrict__ out,
                       uint32_t nseg) {
  __shared__ __align__(16) uint8_t s_jump[kWarps][kWarpBytes];
  const uint32_t lane = threadIdx.x & 31;
  // Shuffled from lane 0, the warp index is known to be uniform, so the
  // tables' base goes into a uniform register and the gathers need no add.
  const uint32_t warp = __shfl_sync(kFull, threadIdx.x >> 5, 0);
  uint8_t* tab = s_jump[warp];
  if (lane < kLevels) {
    *reinterpret_cast<uint32_t*>(tab + lane * kTable + kSeg) = 0x80808080u;
  }
  const uint32_t stride = gridDim.x * kWarps;
  uint32_t seg = blockIdx.x * kWarps + warp;
  if (seg >= nseg) return;  // uniform per warp
  const longlong2* src = step + static_cast<size_t>(seg) * (kSeg / 2) + lane;
  uint32_t* dst = out + static_cast<size_t>(seg) * (kSeg / 4) + lane;
  const size_t src_stride = static_cast<size_t>(stride) * (kSeg / 2);
  const size_t dst_stride = static_cast<size_t>(stride) * (kSeg / 4);
  // Two segments in registers, the next one's loads in flight while this
  // one is worked on.
  longlong2 lo[2], hi[2];
  lo[0] = __ldg(src);
  hi[0] = __ldg(src + 32);
  while (true) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool more = seg + stride < nseg;
      if (more) {
        lo[i ^ 1] = __ldg(src + src_stride);
        hi[i ^ 1] = __ldg(src + src_stride + 32);
      }
      *dst = cover_word(lo[i], hi[i], lane, tab, tab + kLevels * kTable);
      if (!more) return;
      seg += stride;
      src += src_stride;
      dst += dst_stride;
    }
  }
}

}  // namespace

// step: (nseg * 128,) int64, 16-byte aligned; out: (nseg * 128,) bool, 4-byte
// aligned.
extern "C" int compu_parse_cover(const void* step, void* out, long long nseg,
                                 void* stream) {
  if (nseg <= 0 || nseg >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[64];  // blocks the card holds at once, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, fit = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, parse_cover_kernel,
                                                          kWarps * 32, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * fit;
  }
  const long long need = (nseg + kWarps - 1) / kWarps;
  const long long blocks = need < resident[dev] ? need : resident[dev];
  parse_cover_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(step), static_cast<uint32_t*>(out),
      static_cast<uint32_t>(nseg));
  return static_cast<int>(cudaGetLastError());
}
