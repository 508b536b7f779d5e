// The speculative 48-phase chunk scan of the foreign-stream inflate, P4.
//
// Replaces: spec_scan_wave of compu_tpu/kernels/inflate_spec.py:58, a
// jax.lax.while_loop (:162) over its step (:76). Not a TPU kernel: XLA ran
// it as one while loop. Plain version: compu_tpu_torch/kernels/
// inflate_spec.py spec_scan_wave_torch.
//
// A wave is 256 chunks of 512 bits from wave_bit0, each entered at 48 bit
// phases: 12,288 lanes. Lane (chunk, phase) decodes from bit wave_bit0 +
// chunk * 512 + phase with the block's code tables (build_foreign_tables):
//   a = lit/len entry of the next 15 bits: kind (2) | clen (4) | lxb (3) | arg (8)
//   literal: record 1 | 1 << 9 | byte << 10
//   match:   d = distance entry of the 15 bits after clen + lxb:
//            valid | dlen | dxb | base - 1, record (3 + arg + extra) |
//            (dist - 1) << 10; an invalid d is bad
//   EOB:     eob_bit = bit + clen; an invalid code (kind 3) is bad.
// An entry is the 12-bit primary's; where that is invalid (no code of 12
// bits or fewer fits), the first of the lengths 13..15 whose canonical
// range holds the window's code gives its symbol's record, else the
// primary entry stands: the reference's 15-bit direct tables exactly.
// It runs at most 48 steps. A step starts at the 128-bit group that holds
// the lane's bit and takes up to 4 tokens that start before the group's
// bit 320. The lane retires after the token that reaches its chunk's end,
// at EOB, at total_bits or at a bad token, and starts retired at or past
// total_bits; one not retired after 48 steps has overflowed its 192 slots
// and is bad. Its k-th literal or match goes to record slot k; slots at
// and past its nrec are not written. Per lane it writes exit_rel =
// clip(bit - chunk_end, 0, 47), eob_bit (-1 without EOB), flags (1 EOB,
// 2 bad), nrec and outp. Bits past the stream read as 0.
//
// Bound on the H100: its chain, the longest lane's table reads (one a
// literal or EOB, two a match, each waiting on the token before), beside
// the bytes (the defined records, sum nrec x 4 B, about 1.8 MB a wave of
// a level-6 stream; the tables, 34,400 B; the wave's 16 KiB of stream; the
// lanes' five words). On the card a lane's token is a whole iteration of
// dependent instructions, issued in order by a warp that has its
// scheduler to itself, so the longest warp's iterations set the time.
//
// Design. The earlier one read 15-bit tables (2 x 128 KiB) through the
// read-only cache: a token was two or three dependent global loads of
// ~700 cycles each, and every lane wrote all 192 record slots, mostly
// zeros. Now:
// - Tables. The block's tables are 8,600 words: the 12-bit lit/len and
//   distance primaries (2 x 16 KiB), each code's canonical (first, count,
//   base) for the lengths 1..15, and its symbols' records in canonical
//   order. Each CUDA block copies them into shared memory by 16-byte
//   cp.async before it scans, and keeps each code's (first, count, base)
//   of the lengths 13..15 in registers. A token's two table reads are
//   shared reads; a code longer than 12 bits (rare: a level-6 block has a
//   few dozen of its 288) or a bad token takes one rarely-taken branch,
//   where the walk is three compares and a read of the symbol's record.
// - Stream. The CUDA block's span of the padded stream (its lanes' chunks
//   and the words the window after a lane's last token reaches) is copied
//   into shared memory beside them; a token's 64-bit window is three span
//   words and two funnel shifts, read for the next token as soon as this
//   one's length is known, so the read overlaps the record's arithmetic.
// - The iteration. The distance entry is read for every token (a warp
//   whose lanes hold literals and matches takes one path), all arithmetic
//   is on 32-bit words (a match's codes and extra bits take at most 48
//   bits of the window), and the record's store and the step rule are
//   predicated, not branched.
// - Records. A lane stores its k-th record at rec[k * 12,288 + lane]: the
//   48 lanes of a chunk fall into step with one another after a few tokens
//   (the code resynchronises), so a warp's store meets a few lines, and
//   only the defined records are written.
// - Lanes a CUDA block: 128, by measurement (64 and 256 were slower: one
//   block an SM, a warp a scheduler).

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
constexpr int kMaxBits = 15;
constexpr int kBlockLanes = 128;
static_assert(kLanes % kBlockLanes == 0, "the grid covers the lanes exactly");

// The tables' layout, in 32-bit words (kernels/inflate_spec.py).
constexpr int kPrimBits = 12;
constexpr uint32_t kPrimMask = (1u << kPrimBits) - 1;
constexpr int kLitPrim = 0;
constexpr int kDistPrim = 1 << kPrimBits;
constexpr int kCanon = 2 << kPrimBits;  // lit/len, then distance: (first, count, base) a length
constexpr int kLitSyms = kCanon + 2 * kMaxBits * 3;
constexpr int kDistSyms = kLitSyms + 288;
constexpr int kTableWords = 8600;
static_assert(kTableWords == (kDistSyms + 30 + 3) / 4 * 4, "whole 16-byte units");

// Words of stream a block stages: its chunks and the four words past the
// last one that a window can reach: a lane's last token starts before its
// chunk's end, and the window after it is read too.
constexpr int kSpanWords = ((kBlockLanes - 1) / kPhases + 2) * (kChunkBits / 32) + 6;

__device__ __forceinline__ void cp_async16(void* shared, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// One code's canonical (first, count, base) for the lengths 13..15, in
// registers.
struct LongCodes {
  uint32_t first[3], count[3], base[3];

  __device__ __forceinline__ LongCodes(const uint32_t* canon) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      first[k] = canon[3 * (kPrimBits + k)];
      count[k] = canon[3 * (kPrimBits + k) + 1];
      base[k] = canon[3 * (kPrimBits + k) + 2];
    }
  }

  // The record of a window whose primary entry `a` is invalid: the
  // symbol of the length 13..15 whose canonical range holds the window's
  // code (at most one does), from `syms`, its records in canonical order;
  // else `a`.
  __device__ __forceinline__ uint32_t walk(const uint32_t* syms, uint32_t win, uint32_t a) const {
    const uint32_t rev = __brev(win) >> (32 - kMaxBits);  // the window's 15 bits, first bit highest
    uint32_t at = ~0u;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t off = (rev >> (2 - k)) - first[k];
      if (off < count[k]) at = base[k] + off;
    }
    return at == ~0u ? a : syms[at];
  }
};

__global__ void __launch_bounds__(kBlockLanes)
inflate_spec_kernel(const uint32_t* __restrict__ words, long long nwords,
                    const uint4* __restrict__ tables, int wave_bit0, int total_bits,
                    int32_t* __restrict__ lanes_out, int32_t* __restrict__ rec) {
  __shared__ __align__(16) uint32_t s_tab[kTableWords];
  __shared__ uint32_t s_span[kSpanWords];

  for (int i = threadIdx.x; i < kTableWords / 4; i += kBlockLanes)
    cp_async16(s_tab + 4 * i, tables + i);
  const int lane0 = blockIdx.x * kBlockLanes;
  const long long g0 = (wave_bit0 + lane0 / kPhases * kChunkBits) >> 5;
  const int g1 = static_cast<int>(
      ((wave_bit0 + ((lane0 + kBlockLanes - 1) / kPhases + 1) * kChunkBits - 1) >> 5) + 4 - g0);
  for (int i = threadIdx.x; i <= g1; i += kBlockLanes)
    s_span[i] = g0 + i < nwords ? __ldg(words + g0 + i) : 0u;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // The lane's position is kept relative to the span's first bit.
  const int span_bit0 = static_cast<int>(g0 * 32);
  const int lane = lane0 + threadIdx.x;
  const int chunk_end = wave_bit0 + (lane / kPhases + 1) * kChunkBits;
  int rel = chunk_end - kChunkBits + lane % kPhases - span_bit0;
  const int stop = min(chunk_end, total_bits) - span_bit0;
  bool eob = false, bad = false, over = false, live = rel < stop;
  int outp = 0, nrec = 0;
  int step = 0, taken = 0;
  int limit = ((rel + span_bit0) & ~127) + kMaxPhase + 1 - span_bit0;
  int q = rel >> 5;
  uint32_t w0 = s_span[q], w1 = s_span[q + 1], w2 = s_span[q + 2];
  const LongCodes lit_long(s_tab + kCanon), dist_long(s_tab + kCanon + kMaxBits * 3);
  while (live) {
    // A token: the lit/len entry of its window, then the distance entry at
    // the bits after the length code and its extra bits, read for every
    // token (a warp whose lanes hold literals and matches takes one path);
    // all in 32-bit words, a match's codes and extra bits taking at most
    // 48 bits. A code longer than 12 bits, or a bad token, takes the walk.
    const uint32_t lo = __funnelshift_r(w0, w1, rel);
    const uint32_t hi = __funnelshift_r(w1, w2, rel);
    uint32_t a = s_tab[kLitPrim + (lo & kPrimMask)];
    uint32_t sh = ((a >> 2) & 15) + ((a >> 6) & 7);
    uint32_t wd = __funnelshift_r(lo, hi, sh);
    uint32_t d = s_tab[kDistPrim + (wd & kPrimMask)];
    if ((a & 3) == 3 || ((a & 3) == 1 && (d & 1) == 0)) {
      if ((a & 3) == 3) a = lit_long.walk(s_tab + kLitSyms, lo, a);
      sh = ((a >> 2) & 15) + ((a >> 6) & 7);
      wd = __funnelshift_r(lo, hi, sh);
      d = s_tab[kDistPrim + (wd & kPrimMask)];
      if ((a & 3) == 1 && (d & 1) == 0) d = dist_long.walk(s_tab + kDistSyms, wd, d);
    }
    const uint32_t kind = a & 3, clen = (a >> 2) & 15;
    const bool match = kind == 1, emit = kind < 2;
    const uint32_t dlen = (d >> 1) & 15, dxb = (d >> 5) & 15;
    const int next = rel + static_cast<int>(match ? sh + dlen + dxb : kind == 3 ? 0 : clen);
    // The next token's window is in flight while this one is recorded.
    q = next >> 5;
    w0 = s_span[q];
    w1 = s_span[q + 1];
    w2 = s_span[q + 2];
    const uint32_t arg = (a >> 9) & 0xFF, lxb = (a >> 6) & 7;
    const uint32_t mlen = 3 + arg + ((lo >> clen) & ((1u << lxb) - 1));
    const uint32_t dm1 = ((d >> 9) & 0x7FFF) + ((wd >> dlen) & ((1u << dxb) - 1));
    const uint32_t r = match ? mlen | dm1 << 10 : 1 | 1 << 9 | arg << 10;
    if (emit) rec[nrec * kLanes + lane] = static_cast<int32_t>(r);
    nrec += emit;
    outp += match ? static_cast<int>(mlen) : emit;
    eob = kind == 2;
    bad = kind == 3 || (match && (d & 1) == 0);
    rel = next;
    // The step rule: the next token opens a step after 4 tokens or at the
    // bit at phase 320 of the step's first 128-bit group; a lane that would
    // open a 49th has overflowed.
    const bool opens = ++taken == kKF || rel >= limit;
    step += opens;
    taken = opens ? 0 : taken;
    limit = opens ? ((rel + span_bit0) & ~127) + kMaxPhase + 1 - span_bit0 : limit;
    const bool fin = eob || bad || rel >= stop;
    over = !fin && step == kSteps;
    live = !fin && !over;
  }
  bad = bad || over;  // record-slot overflow
  const int eob_bit = eob ? rel + span_bit0 : -1;  // an EOB token advances by its code
  const int exit_rel = min(max(rel + span_bit0 - chunk_end, 0), kPhases - 1);
  lanes_out[lane] = exit_rel;
  lanes_out[kLanes + lane] = eob_bit;
  lanes_out[2 * kLanes + lane] = static_cast<int>(eob) | static_cast<int>(bad) << 1;
  lanes_out[3 * kLanes + lane] = nrec;
  lanes_out[4 * kLanes + lane] = outp;
}

}  // namespace

// comp: the stream as nwords little-endian 32-bit words, 4-byte aligned;
// tables: (8600,) i32, 16-byte aligned; lanes: (5, 12288) i32 (exit_rel,
// eob_bit, flags, nrec, outp); rec: (192, 12288) i32, slot k of lane l at
// k * 12288 + l, written for k < nrec.
extern "C" int compu_inflate_spec(const void* comp, long long nwords, const void* tables,
                                  long long wave_bit0, long long total_bits, void* lanes,
                                  void* rec, void* stream) {
  const long long reach = kWaveChunks * kChunkBits + kRF * kPhases;
  if (reinterpret_cast<uintptr_t>(comp) % 4 || reinterpret_cast<uintptr_t>(tables) % 16 ||
      nwords < 0 || wave_bit0 < 0 || total_bits < 0 || total_bits > 32 * nwords ||
      wave_bit0 + reach >= (1LL << 31) || total_bits + reach >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  inflate_spec_kernel<<<kLanes / kBlockLanes, kBlockLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(comp), nwords, static_cast<const uint4*>(tables),
      static_cast<int>(wave_bit0), static_cast<int>(total_bits), static_cast<int32_t*>(lanes),
      static_cast<int32_t*>(rec));
  return static_cast<int>(cudaGetLastError());
}
