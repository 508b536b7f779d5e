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
//   idx     = idx_pos >= 0 ? (w >> (idx_pos - 8j)) & mask
//                          : (w << min(-idx_pos, 16)) & mask   // zero fill
//   out[k]  = symbol[idx];  bits -= nbits[idx]
// and flags: ok (no nbits == 0 met, bits >= -64 at the end: the device
// rule of the reference) and host_ok (the same at -32: HufTable's rule).
// The counter only falls, so checking the last value checks every step's.
//
// Bound on the H100: latency. Each step's window position is the previous
// step's table read, so a lane is a chain of dependent steps: the 3 stream
// bytes, which the previous steps brought into L1, then the table read
// from shared memory, and the integer ops between. Device-memory traffic
// is each stream's bytes read once and one byte written a step. Four
// lanes a section.
//
// Design: a block per section, one thread a lane (a loop when a section
// has more lanes than the block's threads). The section's table is packed
// into shared memory as 16-bit entries (symbol | nbits << 8), so a step
// makes one shared read; positions are 32-bit (scap < 2^28). A register
// window of 8 stream bytes, moved 5 bytes down every 40 bits with the next
// 5 prefetched, took longer a step on the H100 (2.41 against 1.64 ms on a
// 17,022-step section, PERF.md §6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTable = 2048;  // 2^11 entries, the largest zstd table
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    huf_decode_lanes_kernel(const uint8_t* __restrict__ streams, int scap,
                            const int32_t* __restrict__ bits0,
                            const int32_t* __restrict__ counts,
                            const uint8_t* __restrict__ symbol,
                            const uint8_t* __restrict__ nbits,
                            const int32_t* __restrict__ max_bits, int lanes,
                            uint8_t* __restrict__ out, int max_steps,
                            uint8_t* __restrict__ ok,
                            uint8_t* __restrict__ host_ok) {
  __shared__ uint16_t tab[kTable];
  const int sec = blockIdx.x;
  const int m = max_bits[sec];
  const int size = 1 << m;
  const uint8_t* sym = symbol + static_cast<long long>(sec) * kTable;
  const uint8_t* nb_of = nbits + static_cast<long long>(sec) * kTable;
  for (int e = threadIdx.x; e < size; e += blockDim.x)
    tab[e] = static_cast<uint16_t>(sym[e] | (nb_of[e] << 8));
  __syncthreads();

  const unsigned mask = static_cast<unsigned>(size - 1);
  const int jmax = scap - 3;
  for (int t = threadIdx.x; t < lanes; t += blockDim.x) {
    const long long lane = static_cast<long long>(sec) * lanes + t;
    const uint8_t* s = streams + lane * scap;
    uint8_t* o = out + lane * max_steps;
    const int cnt = max(0, min(counts[lane], max_steps));
    int bits = bits0[lane];
    bool bad = false;
    for (int k = 0; k < cnt; ++k) {
      const int idx_pos = bits - m;
      const int j = min(max(idx_pos, 0) >> 3, jmax);
      const unsigned w = static_cast<unsigned>(__ldg(s + j)) |
                         (static_cast<unsigned>(__ldg(s + j + 1)) << 8) |
                         (static_cast<unsigned>(__ldg(s + j + 2)) << 16);
      // A shift past 24 reads only zero bits: cap it below 32.
      const unsigned idx = idx_pos >= 0 ? (w >> min(idx_pos - 8 * j, 31)) & mask
                                        : (w << min(-idx_pos, 16)) & mask;
      const int entry = tab[idx];
      const int nb = entry >> 8;
      o[k] = static_cast<uint8_t>(entry);
      bad |= nb == 0;
      bits -= nb;
    }
    for (int k = cnt; k < max_steps; ++k) o[k] = 0;
    ok[lane] = !bad && bits >= -64;
    host_ok[lane] = !bad && bits >= -32;
  }
}

}  // namespace

// streams: (sections * lanes, scap) u8, 8 <= scap < 2^28; bits0, counts:
// (sections * lanes,) i32; symbol, nbits: (sections, 2048) u8; max_bits:
// (sections,) i32 in 0..11; out: (sections * lanes, max_steps) u8; ok,
// host_ok: (sections * lanes,) bool.
extern "C" int compu_huf_decode_lanes(const void* streams, int scap,
                                      const void* bits0, const void* counts,
                                      const void* symbol, const void* nbits,
                                      const void* max_bits, int lanes,
                                      int sections, void* out, int max_steps,
                                      void* ok, void* host_ok, void* stream) {
  const int warps = (lanes + 31) / 32 * 32;
  const int threads = warps < kMaxThreads ? warps : kMaxThreads;
  huf_decode_lanes_kernel<<<sections, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(streams), scap,
      static_cast<const int32_t*>(bits0), static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(symbol), static_cast<const uint8_t*>(nbits),
      static_cast<const int32_t*>(max_bits), lanes,
      static_cast<uint8_t*>(out), max_steps, static_cast<uint8_t*>(ok),
      static_cast<uint8_t*>(host_ok));
  return static_cast<int>(cudaGetLastError());
}
