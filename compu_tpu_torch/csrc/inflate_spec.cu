// The speculative 48-phase chunk scan of the foreign-stream inflate, P4.
//
// Replaces: spec_scan_wave of compu_tpu/kernels/inflate_spec.py:58, a
// jax.lax.while_loop (:162) over its step (:76). Not a TPU kernel: XLA ran
// it as one while loop. Plain version: compu_tpu_torch/kernels/
// inflate_spec.py spec_scan_wave_torch.
//
// A wave is 256 chunks of 512 bits from wave_bit0, each entered at 48 bit
// phases: 12,288 lanes. Lane (chunk, phase) decodes from bit wave_bit0 +
// chunk * 512 + phase with the block's 15-bit direct tables:
//   a = lit[next 15 bits]: kind (2) | clen (4) | lxb (3) | arg (8)
//   literal: record 1 | 1 << 9 | byte << 10
//   match:   d = dist[15 bits after clen + lxb]: valid | dlen | dxb | base - 1,
//            record (3 + arg + extra) | (dist - 1) << 10; invalid d is bad
//   EOB:     eob_bit = bit + clen; an invalid code (kind 3) is bad.
// It runs at most 48 steps. A step starts at the 128-bit group that holds
// the lane's bit and takes up to 4 tokens that start before the group's
// bit 320; token j of step t goes to record slot t * 4 + j, and a slot
// that emits nothing holds 0. The lane retires after the token that
// reaches its chunk's end, at EOB, at total_bits or at a bad token, and
// starts retired at or past total_bits; one not retired after 48 steps
// has overflowed its 192 slots and is bad. Per lane it writes exit_rel =
// clip(bit - chunk_end, 0, 47), eob_bit (-1 without EOB), flags (1 EOB,
// 2 bad), nrec and outp. Bits past the stream read as 0.
//
// Bound on the H100: by bytes, the records (192 slots x 12,288 lanes x
// 4 B = 9.4 MB a wave, written once) beside the tables (2 x 128 KiB) and
// the wave's 16 KiB of stream; by its chain, the longest lane's table
// reads (one a literal, two a match, each waiting on the one before).
//
// Design (the first, simple one): one thread a lane, 64 lanes a CUDA
// block (192 blocks, spread over the SMs: the work is a few warps an SM of
// dependent reads). The 15-bit tables do not fit in shared memory (2 x
// 128 KiB), so they are read through the read-only cache. Each token reads
// a 64-bit window by position (three stream words, two funnel shifts),
// enough for a match's codes and extra bits. Records are stored
// slot-major, (192, 12,288), so a warp's 32 lanes store each slot as one
// coalesced 128-byte line; after the lane retires it writes 0 to the rest
// of its slots, so every record word is written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 48;
constexpr int kChunkBits = 512;
constexpr int kWaveChunks = 256;
constexpr int kLanes = kWaveChunks * kPhases;
constexpr int kKF = 4;                  // token slots a step
constexpr int kRF = 192;                // record slots a lane
constexpr int kSteps = kRF / kKF;
constexpr int kMaxPhase = 319;          // a token starts at most this far past its step's group
constexpr uint32_t kMask = (1u << 15) - 1;
constexpr int kThreads = 64;            // lanes a CUDA block
static_assert(kLanes % kThreads == 0, "the grid covers the lanes exactly");

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            long long nwords, long long g) {
  return g < nwords ? __ldg(words + g) : 0u;
}

// The 64 stream bits from `bit`, LSB first.
__device__ __forceinline__ uint64_t window(const uint32_t* __restrict__ words,
                                           long long nwords, int bit) {
  const long long q = bit >> 5;
  const uint32_t sh = bit & 31;
  const uint32_t w0 = word_at(words, nwords, q);
  const uint32_t w1 = word_at(words, nwords, q + 1);
  const uint32_t w2 = word_at(words, nwords, q + 2);
  const uint32_t lo = __funnelshift_r(w0, w1, sh);
  const uint32_t hi = __funnelshift_r(w1, w2, sh);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

__global__ void __launch_bounds__(kThreads)
inflate_spec_kernel(const uint32_t* __restrict__ words, long long nwords,
                    const int32_t* __restrict__ lit, const int32_t* __restrict__ dist,
                    int wave_bit0, int total_bits, int32_t* __restrict__ lanes_out,
                    int32_t* __restrict__ rec) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int chunk_end = wave_bit0 + (lane / kPhases + 1) * kChunkBits;
  int bit = chunk_end - kChunkBits + lane % kPhases;
  bool done = bit >= total_bits;
  bool eob = false, bad = false;
  int eob_bit = -1, outp = 0, nrec = 0;
  int32_t* slot = rec + lane;  // slot s of this lane: slot[s * kLanes]
  int t = 0;
  for (; t < kSteps && !done; ++t) {
    const int limit = (bit & ~127) + kMaxPhase + 1;
#pragma unroll
    for (int j = 0; j < kKF; ++j) {
      int32_t r = 0;
      if (!done && bit < limit) {
        const uint64_t win = window(words, nwords, bit);
        const int a = __ldg(lit + (win & kMask));
        const int kind = a & 3;
        const int clen = (a >> 2) & 15;
        int adv = clen;
        if (kind == 0) {
          r = 1 | 1 << 9 | ((a >> 9) & 0xFF) << 10;
          outp += 1;
          nrec += 1;
        } else if (kind == 1) {
          const int lxb = (a >> 6) & 7;
          const int mlen = 3 + ((a >> 9) & 0xFF) +
                           static_cast<int>((win >> clen) & ((1u << lxb) - 1));
          const uint64_t wd = win >> (clen + lxb);
          const int d = __ldg(dist + (wd & kMask));
          const int dlen = (d >> 1) & 15;
          const int dxb = (d >> 5) & 15;
          const int dm1 = ((d >> 9) & 0x7FFF) + static_cast<int>((wd >> dlen) & ((1u << dxb) - 1));
          bad = (d & 1) == 0;
          r = mlen | dm1 << 10;
          outp += mlen;
          nrec += 1;
          adv = clen + lxb + dlen + dxb;
        } else if (kind == 2) {
          eob = true;
          eob_bit = bit + clen;
        } else {
          bad = true;
          adv = 0;
        }
        bit += adv;
        done = eob || bad || bit >= chunk_end || bit >= total_bits;
      }
      slot[(t * kKF + j) * kLanes] = r;
    }
  }
  for (int s = t * kKF; s < kRF; ++s) slot[s * kLanes] = 0;
  bad = bad || !done;  // record-slot overflow
  const int exit_rel = min(max(bit - chunk_end, 0), kPhases - 1);
  lanes_out[lane] = exit_rel;
  lanes_out[kLanes + lane] = eob_bit;
  lanes_out[2 * kLanes + lane] = static_cast<int>(eob) | static_cast<int>(bad) << 1;
  lanes_out[3 * kLanes + lane] = nrec;
  lanes_out[4 * kLanes + lane] = outp;
}

}  // namespace

// comp: the stream as nwords little-endian 32-bit words, 4-byte aligned;
// lit, dist: (2^15,) i32 tables; lanes: (5, 12288) i32 (exit_rel, eob_bit,
// flags, nrec, outp); rec: (192, 12288) i32.
extern "C" int compu_inflate_spec(const void* comp, long long nwords, const void* lit,
                                  const void* dist, long long wave_bit0, long long total_bits,
                                  void* lanes, void* rec, void* stream) {
  const long long reach = kWaveChunks * kChunkBits + kRF * kPhases;
  if (reinterpret_cast<uintptr_t>(comp) % 4 || nwords < 0 || wave_bit0 < 0 || total_bits < 0 ||
      total_bits > 32 * nwords || wave_bit0 + reach >= (1LL << 31) ||
      total_bits + reach >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  inflate_spec_kernel<<<kLanes / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(comp), nwords, static_cast<const int32_t*>(lit),
      static_cast<const int32_t*>(dist), static_cast<int>(wave_bit0),
      static_cast<int>(total_bits), static_cast<int32_t*>(lanes), static_cast<int32_t*>(rec));
  return static_cast<int>(cudaGetLastError());
}
