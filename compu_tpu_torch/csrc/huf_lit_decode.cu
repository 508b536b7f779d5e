// The 4-stream Huffman literal decode of zstd (RFC 8878 §3.1.1.3.1), P2.
//
// Replaces: the jax.lax.fori_loop in compu_tpu/kernels/zstd_lit_decode_jax.py
// (_decode_lanes). Not a TPU kernel: XLA ran the loop as one while loop.
// Plain version: compu_tpu_torch/kernels/zstd_lit_decode.py
// huf_decode_lanes_torch.
//
// A lane is one backward bitstream. With m = max_bits of its section and
// `bits` its counter (the stream's bit count without the sentinel), each of
// min(count, max_steps) steps does
//   idx_pos = bits - m
//   j       = min(max(idx_pos, 0) >> 3, scap - 3)
//   w       = stream[j] | stream[j+1] << 8 | stream[j+2] << 16
//   idx     = idx_pos >= 0 ? (w >> min(idx_pos - 8j, 31)) & mask
//                          : (w << min(-idx_pos, 16)) & mask   // zero fill
//   out[k]  = symbol[idx];  bits -= nbits[idx]
// and flags: ok (no nbits == 0 met, bits >= -64 at the end: the device
// rule of the reference) and host_ok (the same at -32: HufTable's rule).
// The counter only falls, so checking the last value checks every step's.
// The window is stream bits [idx_pos, idx_pos + m) of the row read as a
// bit string that is zero below bit 0 and from bit 8 * scap on: the clamp
// at scap - 3 and the capped shifts give exactly that, and so do rows
// padded with zero bytes.
//
// Bound on the H100: latency. Each step's window position is the previous
// step's table read, so a lane is a chain of dependent steps: the table
// read from shared memory and the integer ops between. Device-memory
// traffic is each stream's bytes read once and one byte written a step.
// Four lanes a section.
//
// Design: a block per section, one thread a lane (a loop when a section
// has more lanes than the block's threads); zstd's HUF_decompress4X1 inner
// loop. The stream bits sit in a 64-bit register container (hi:lo) whose
// top m bits are the next code's index. A step is
//   at = funnelshift_rc(hi, base >> m, 32 - m)   // table base + index
//   nb = nbits8[at]; sym = symbol8[at]; (hi:lo) <<= nb
// two shifts and the shared read on the chain: the table (nbits, then
// symbol, a byte each) sits at a shared address aligned to 2^11, so the
// shift that extracts the index also adds the base. Steps go in groups of
// G = 64 / m (7 at m = 9, 5 at m = 11): a group never leaves the container
// when no code is longer than m (no Huffman table has one; a table that
// does takes a path with a fresh window a step). At each group's start the
// container takes bits [bits - 64, bits) out of five 32-bit words loaded
// at the previous group's start (which cover every position the group can
// end at) with two funnel shifts, and the loads for the next group go out.
// The words come from shared memory: the block first copies its section's
// rows there (a legal zstd block holds at most 128 KiB, so a section's
// rows fit; rows of more than kStageMax bytes in all are read from device
// memory the same way). One byte store a step, off the chain.
// The earlier design (three byte loads from device memory a step) and the
// other forms tried are in PERF.md §6.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTable = 2048;  // 2^11 entries, the largest zstd table
constexpr int kThreads = 256;
constexpr int kStageMax = 196 << 10;  // rows staged in shared memory, bytes

// The table's bytes with room to align it to 2^11 (table_base), and the
// staged rows.
__shared__ uint8_t s_raw[3 * kTable];
extern __shared__ __align__(16) uint32_t s_rows[];

__device__ __forceinline__ uint32_t table_base() {
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(s_raw));
  return (raw + kTable - 1) & ~static_cast<uint32_t>(kTable - 1);
}

__device__ __forceinline__ int lds_u8(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int lds_u8_sym(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u8 %0, [%1+2048];" : "=r"(v) : "r"(addr));
  return v;
}

// Word q of a row of nw 32-bit words, 0 outside the row: from device
// memory, or from the rows staged at a shared address.
struct GlobalRow {
  const uint32_t* row;
  int nw;
  __device__ __forceinline__ uint32_t operator()(int q) const {
    return static_cast<unsigned>(q) < static_cast<unsigned>(nw) ? __ldg(row + q) : 0u;
  }
};

struct SharedRow {
  uint32_t addr;  // shared address of the row
  int nw;
  __device__ __forceinline__ uint32_t operator()(int q) const {
    uint32_t v = 0;
    if (static_cast<unsigned>(q) < static_cast<unsigned>(nw))
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr + 4 * q));
    return v;
  }
};

// Decode one lane in groups of G steps (G * m <= 64, no code longer than
// m). Returns the final counter; sets `bad` if an empty cell (nbits 0) was
// met.
template <int G, class Row>
__device__ __forceinline__ int decode_lane(Row row, int bits, int cnt, int m, uint8_t* o8,
                                           bool& bad) {
  const int down = 32 - m;
  const uint32_t bhi = table_base() >> m;
  bool bd = false;
  uint32_t nx[5];
  int qn = 0;
  // The words of every window of a group that starts at counter b.
  auto fetch = [&](int b) {
    qn = (b - G * m - 64) >> 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) nx[i] = row(qn + i);
  };
  // Steps i < rest of the group that starts at step k.
  auto group = [&](int k, int rest) {
    const int o = bits - 64 - 32 * qn;  // in [0, G*m + 31]: from word o >> 5
    const uint32_t w0 = nx[0], w1 = nx[1], w2 = nx[2], w3 = nx[3], w4 = nx[4];
    fetch(bits);
    const int q = o >> 5, r = o & 31;
    const uint32_t a = q == 0 ? w0 : q == 1 ? w1 : w2;
    const uint32_t b = q == 0 ? w1 : q == 1 ? w2 : w3;
    const uint32_t c = q == 0 ? w2 : q == 1 ? w3 : w4;
    uint32_t lo = __funnelshift_r(a, b, r);
    uint32_t hi = __funnelshift_r(b, c, r);
    int used = 0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i < rest) {
        const uint32_t ad = __funnelshift_rc(hi, bhi, down);
        const int nb = lds_u8(ad);
        const int sym = lds_u8_sym(ad);
        hi = __funnelshift_l(lo, hi, nb);
        lo <<= nb;
        used += nb;
        bd |= nb == 0;
        o8[k + i] = static_cast<uint8_t>(sym);
      }
    }
    bits -= used;
  };
  fetch(bits);
  const int full = cnt / G * G;
  for (int k = 0; k < full; k += G) group(k, G);
  if (full < cnt) group(full, cnt - full);
  bad = bd;
  return bits;
}

// The same for any table (a code may be longer than m): a fresh window of
// bits [bits - 64, bits) a step.
template <class Row>
__device__ int decode_lane_any(Row row, int bits, int cnt, int m, uint8_t* o8, bool& bad) {
  bool bd = false;
  for (int k = 0; k < cnt; ++k) {
    const int b0 = bits - 64, q = b0 >> 5, r = b0 & 31;
    const uint32_t hi = __funnelshift_r(row(q + 1), row(q + 2), r);
    const uint32_t at = table_base() + __funnelshift_rc(hi, 0u, 32 - m);
    const int nb = lds_u8(at);
    o8[k] = static_cast<uint8_t>(lds_u8_sym(at));
    bd |= nb == 0;
    bits -= nb;
  }
  bad = bd;
  return bits;
}

// decode_lane at G = 64 / m, or decode_lane_any.
template <class Row>
__device__ __forceinline__ int decode_m(Row row, int bits, int cnt, int m, bool any,
                                            uint8_t* o8, bool& bad) {
  if (any) return decode_lane_any(row, bits, cnt, m, o8, bad);
  switch (m) {
    case 11: return decode_lane<5>(row, bits, cnt, m, o8, bad);
    case 10: return decode_lane<6>(row, bits, cnt, m, o8, bad);
    case 9: return decode_lane<7>(row, bits, cnt, m, o8, bad);
    case 8: return decode_lane<8>(row, bits, cnt, m, o8, bad);
    case 7: return decode_lane<9>(row, bits, cnt, m, o8, bad);
    case 6: return decode_lane<10>(row, bits, cnt, m, o8, bad);
    case 5: return decode_lane<12>(row, bits, cnt, m, o8, bad);
    default: return decode_lane<16>(row, bits, cnt, m, o8, bad);
  }
}

__global__ void __launch_bounds__(kThreads)
    huf_decode_lanes_kernel(const uint8_t* __restrict__ streams, int scap,
                            const int32_t* __restrict__ bits0,
                            const int32_t* __restrict__ counts,
                            const uint8_t* __restrict__ symbol,
                            const uint8_t* __restrict__ nbits,
                            const int32_t* __restrict__ max_bits, int lanes,
                            uint8_t* __restrict__ out, int max_steps,
                            uint8_t* __restrict__ ok,
                            uint8_t* __restrict__ host_ok, bool stage) {
  const int sec = blockIdx.x;
  const int m = max_bits[sec];
  const int size = 1 << m;
  const uint8_t* sym = symbol + static_cast<long long>(sec) * kTable;
  const uint8_t* nb_of = nbits + static_cast<long long>(sec) * kTable;
  uint8_t* tab = s_raw + (table_base() - static_cast<uint32_t>(__cvta_generic_to_shared(s_raw)));
  int longer = 0;
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    tab[e] = nb_of[e];
    tab[kTable + e] = sym[e];
    longer |= nb_of[e] > m;
  }
  const int nw = scap >> 2;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      streams + static_cast<long long>(sec) * lanes * scap);
  if (stage) {
#pragma unroll 4
    for (int e = threadIdx.x; e < lanes * nw; e += blockDim.x) s_rows[e] = __ldg(src + e);
  }
  const bool any = __syncthreads_or(longer);
  const uint32_t rows_s = static_cast<uint32_t>(__cvta_generic_to_shared(s_rows));

  for (int t = threadIdx.x; t < lanes; t += blockDim.x) {
    const long long lane = static_cast<long long>(sec) * lanes + t;
    uint8_t* o8 = out + lane * max_steps;
    const int cnt = max(0, min(counts[lane], max_steps));
    bool bad;
    const int bits = stage ? decode_m(SharedRow{rows_s + 4u * t * nw, nw}, bits0[lane], cnt,
                                          m, any, o8, bad)
                           : decode_m(GlobalRow{src + static_cast<long long>(t) * nw, nw},
                                          bits0[lane], cnt, m, any, o8, bad);
    for (int k = cnt; k < max_steps; ++k) o8[k] = 0;
    ok[lane] = !bad && bits >= -64;
    host_ok[lane] = !bad && bits >= -32;
  }
}

}  // namespace

// streams: (sections * lanes, scap) u8, 4-byte aligned, scap a multiple of
// 4 in [8, 2^28); bits0, counts: (sections * lanes,) i32; symbol, nbits:
// (sections, 2048) u8; max_bits: (sections,) i32 in 0..11; out: (sections *
// lanes, max_steps) u8; ok, host_ok: (sections * lanes,) bool.
extern "C" int compu_huf_decode_lanes(const void* streams, int scap,
                                      const void* bits0, const void* counts,
                                      const void* symbol, const void* nbits,
                                      const void* max_bits, int lanes,
                                      int sections, void* out, int max_steps,
                                      void* ok, void* host_ok, void* stream) {
  if (scap % 4 || reinterpret_cast<uintptr_t>(streams) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(lanes) * scap;
  const bool stage = rows <= kStageMax;
  if (stage) {
    const cudaError_t err = cudaFuncSetAttribute(
        huf_decode_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageMax);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = (lanes + 31) / 32 * 32;
  const int threads = stage || warps > kThreads ? kThreads : warps;
  huf_decode_lanes_kernel<<<sections, threads, stage ? static_cast<int>(rows) : 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), scap,
      static_cast<const int32_t*>(bits0), static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(symbol), static_cast<const uint8_t*>(nbits),
      static_cast<const int32_t*>(max_bits), lanes, static_cast<uint8_t*>(out),
      max_steps, static_cast<uint8_t*>(ok), static_cast<uint8_t*>(host_ok), stage);
  return static_cast<int>(cudaGetLastError());
}
