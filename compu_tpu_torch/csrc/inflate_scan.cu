// The segment token scan of the indexed DEFLATE inflate, P3.
//
// Replaces: the phase-1 scan loops of compu_tpu/kernels/inflate_jax_lut.py
// (decode_blocks_indexed_lut, the jax.lax.while_loop at :243 over the
// steps at :166), inflate_jax_dyn.py (:206, steps at :153) and
// inflate_jax.py (:204, steps at :138). Not TPU kernels: XLA ran each as
// one while loop. Plain version: compu_tpu_torch/kernels/inflate_scan.py
// inflate_scan_torch.
//
// One lane a 128-byte output segment of a block. With the block's lit/len
// and distance lookup tables (2^bits packed records, bits 12 or 15), a
// lane starts at bit seg_bits & 0xFFFFFF of its block and output ov =
// seg_bits >> 24 (clamped to target), and runs `rsteps` steps; a step
// starts at phase bit & 127 and takes up to K tokens while the phase,
// grown by each token's bits, is at most 319 (the reference's 384-bit row
// window, as arithmetic). A token is
//   a = lit[next bits]: kind (2) | clen (4) | lxb (3) | arg (8)
//   literal: record outp | 1 << 9 | byte << 10, 1 byte of output
//   match:   d = dist[bits after clen + lxb]: valid | dlen | dxb | base - 1,
//            record outp | (dist - 1) << 10, 3 + arg + extra bytes
// and EOB, an invalid code or distance sets `bad` and ends the lane. The
// lane ends when its output reaches target; every slot it did not fill
// holds exactly 511. Bits past the end of `comps` read as 0.
//
// Bound on the H100: the records' bytes (K * rsteps words a lane, 90% of
// the traffic at K = 6, rsteps = 26) by count; on the card, the longest
// lane's chain: a token's table reads wait on the previous token's length,
// and a warp issues in order, so a lane's step costs its whole
// instruction stream, not only the two reads. The longest lanes are the
// all-literal ones at a deflate block's start (128 literals).
//
// Design. A CUDA block takes 256 lanes of one deflate block, one thread a
// lane, one block an SM (its shared memory):
// - Records. The lanes' rows are staged in shared memory (16-byte aligned
//   at a stride of 4 mod 8 words, so lanes writing the same slot meet in 4
//   banks at most); each warp fills its 32 rows with 511 by 16-byte
//   stores, its lanes store only their tokens, and as soon as they finish
//   the warp copies its rows out, one contiguous run of `rec`, by coalesced
//   16-byte stores (4-byte ones when K * rsteps is not a multiple of 4),
//   while the other warps still scan. Every record word is written once,
//   in full lines. (The earlier design's one scattered 4-byte store a slot,
//   a warp's store touching 32 rows, held it at 0.058 of its byte bound.)
// - Stream bits. The block's run of `comps` (its first lane's word to the
//   next block's first bit, plus the most one lane can read past its own
//   first bit) is copied into shared memory by cp.async at the start, up
//   to a cap. A step reads its bits by position, as the plain version
//   does: three staged words at the lane's bit >> 5 and two funnel shifts
//   give 64 bits, enough for a match's lit/len and distance codes with
//   their extra bits, or two literals. A lane whose whole reach is staged
//   runs a loop with no other check; any other lane's loop reads a word
//   outside the staged run from device memory (only a long or malformed
//   stream or index has one): every input stays exact.
// - Tables. 12-bit tables (2 x 16 KiB) are staged in shared memory, once
//   a block (8 blocks share a deflate block of 256 KiB); 15-bit ones (2 x
//   128 KiB) are read through the read-only cache.
// - The step. An iteration makes two dependent table reads and takes no
//   divergent branch on the common path: the lit/len read, then, at the
//   bits after that token, the distance read for a match or the lit/len
//   read of the next token for a literal, which it takes too when it is a
//   literal and the lane goes on (a run of literals goes two an iteration,
//   a record each, under the same step rules). A step's rules are two
//   compares a token: its slots last (slot < slot_end) and the token
//   starts before E, the bit at phase 320 of the step's first row. The
//   next iteration's bits are read before this one's records are stored.
//   A token not taken stores to the row's pad word and moves nothing.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr uint32_t kNoToken = 511;
constexpr int kMaxPhase = 319;
constexpr int kLanes = 256;           // lanes (threads) a CUDA block
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may take on sm_90
constexpr int kSpanMin = 16 << 10;    // the least staged span a layout leaves, bytes
// The most: the rest of the SM's 256 KiB stays L1, which the 15-bit
// tables are read through.
constexpr int kSpanMax = 64 << 10;
constexpr int kTokenBits = 52;        // the most bits a token takes (22 + 30)
constexpr int kLut12 = 1 << 12;

// Where a launch keeps what in dynamic shared memory, in 32-bit words: the
// 12-bit tables, the record rows, the span.
struct Layout {
  int stride;       // words a staged record row: more than K * rsteps (word R is a pad)
  int table_words;  // 2 * 4096 at 12 bits, 0 at 15
  int span_words;   // capacity of the staged span, a multiple of 4; 0: the rows do not fit

  int bytes() const { return 4 * (table_words + kLanes * stride + span_words); }
};

Layout make_layout(int lut_bits, int K, int rsteps) {
  // Rows of a multiple of 4 words sit 16-byte aligned, at a stride of 4
  // mod 8 words (lanes writing the same slot meet in 4 of 32 banks at
  // most); other rows at an odd stride.
  const int R = K * rsteps;
  int stride = R + 1;
  while (R % 4 == 0 ? stride % 8 != 4 : stride % 2 == 0) ++stride;
  Layout l{stride, lut_bits == 12 ? 2 * kLut12 : 0, 0};
  const long long left = kSmemMax - 4LL * (l.table_words + static_cast<long long>(kLanes) * stride);
  if (left >= kSpanMin) l.span_words = static_cast<int>((left < kSpanMax ? left : kSpanMax) / 16 * 4);
  return l;
}

__device__ __forceinline__ void cp_async16(void* shared, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  const int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// The block's dynamic shared memory (Layout). The scan reads and writes
// it by 32-bit shared addresses (lds, sts), computed from one base.
extern __shared__ __align__(16) uint32_t smem[];

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// 64 stream bits from a position relative to the span's first bit, LSB
// first: three words of the staged span and two funnel shifts, or,
// outside it, three words of the batch from device memory (0 past the
// end).
struct Window {
  const uint32_t* words;
  long long nwords;
  uint32_t span;      // the span's shared address
  unsigned nspan;
  int span_bit0;      // the span's first bit, relative to the block
  long long gbase;    // the block's first bit in the batch

  __device__ __forceinline__ uint32_t word(long long g) const {
    return g < nwords ? __ldg(words + g) : 0u;
  }
  // kChecked: rel may lie outside the staged span.
  template <bool kChecked>
  __device__ __forceinline__ uint64_t at(int rel) const {
    const uint32_t q = static_cast<uint32_t>(rel) >> 5;
    if constexpr (!kChecked) {
      const uint32_t addr = span + 4 * q;
      const uint32_t w0 = lds(addr), w1 = lds(addr + 4), w2 = lds(addr + 8);
      return static_cast<uint64_t>(__funnelshift_r(w1, w2, rel)) << 32 |
             __funnelshift_r(w0, w1, rel);
    }
    const bool staged = q + 2 < nspan;
    const uint32_t addr = span + 4 * (staged ? q : 0);
    uint32_t w0 = lds(addr), w1 = lds(addr + 4), w2 = lds(addr + 8), sh = rel;
    if (__builtin_expect(!staged, 0)) {
      const long long gbit = gbase + span_bit0 + rel;
      const long long g = gbit >> 5;
      sh = static_cast<uint32_t>(gbit);
      w0 = word(g);
      w1 = word(g + 1);
      w2 = word(g + 2);
    }
    return static_cast<uint64_t>(__funnelshift_r(w1, w2, sh)) << 32 | __funnelshift_r(w0, w1, sh);
  }
};

template <int kBits>
__global__ void __launch_bounds__(kLanes) inflate_scan_kernel(
    const uint32_t* __restrict__ words, long long nwords, long long block_bits,
    const int32_t* __restrict__ seg_bits, int S, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ lit_lut, const int32_t* __restrict__ dist_lut, int K,
    int rsteps, Layout lay, uint32_t* __restrict__ rec, int32_t* __restrict__ outp_out,
    uint8_t* __restrict__ bad_out) {
  constexpr int kLut = 1 << kBits;
  constexpr uint32_t kMask = kLut - 1;
  constexpr bool kShared = kBits == 12;
  uint32_t* s_lit = smem;
  uint32_t* s_dist = smem + kLut12;
  uint32_t* s_rec = smem + lay.table_words;
  const int span_off = lay.table_words + kLanes * lay.stride;
  uint32_t* s_span = smem + span_off;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int blk = blockIdx.y;
  const int seg0 = blockIdx.x * kLanes;
  const long long row0 = static_cast<long long>(blk) * S;
  const int R = K * rsteps;
  const int32_t* lit = lit_lut + static_cast<long long>(blk) * kLut;
  const int32_t* dist = dist_lut + static_cast<long long>(blk) * kLut;

  // The block's run of the stream: from its first lane's word (aligned
  // down to 16 bytes) to the next block's first bit, plus the most a lane
  // can read past its first bit (R tokens and a window); none when every
  // lane of the block is inert.
  const long long gbase = static_cast<long long>(blk) * block_bits;
  const long long first = static_cast<uint32_t>(seg_bits[row0 + seg0]) & 0xFFFFFF;
  const long long last = seg0 + kLanes < S
                             ? static_cast<uint32_t>(seg_bits[row0 + seg0 + kLanes]) & 0xFFFFFF
                             : block_bits;
  const long long span_lo = ((gbase + first) >> 5) & ~3LL;
  const int reach = (R * kTokenBits + 64) / 32 + 2;  // words a lane can read
  long long want = ((gbase + last) >> 5) + reach - span_lo;
  if (ns[blk] <= seg0 * kSeg) want = 0;
  want = want < 0 ? 0 : want > lay.span_words ? lay.span_words : want;
  const int nspan = (static_cast<int>(want) + 3) & ~3;
  const int span_bit0 = static_cast<int>(span_lo * 32 - gbase);
  for (int c = tid; c < nspan / 4; c += kLanes) {
    const long long g = span_lo + 4LL * c;
    cp_async16(s_span + 4 * c, g < nwords ? words + g : words, g < nwords);
  }
  if constexpr (kShared) {
    for (int c = tid; c < kLut / 4; c += kLanes) {
      cp_async16(s_lit + 4 * c, lit + 4 * c, true);
      cp_async16(s_dist + 4 * c, dist + 4 * c, true);
    }
  }
  // This warp's rows, all 511, while the copies land.
  {
    uint4* rows = reinterpret_cast<uint4*>(s_rec + warp * 32 * lay.stride);
    const uint4 fill = make_uint4(kNoToken, kNoToken, kNoToken, kNoToken);
    for (int i = wl; i < 8 * lay.stride; i += 32) rows[i] = fill;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // The table reads: LDS from the staged copy, or read-only global loads.
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const auto lit_at = [&](uint32_t i) -> uint32_t {
    if constexpr (kShared) return lds(base + 4 * i);
    else return static_cast<uint32_t>(__ldg(lit + i));
  };
  // The second read: the distance table after a length code, else lit/len.
  const auto second_at = [&](bool match, uint32_t i) -> uint32_t {
    if constexpr (kShared) return lds(base + 4 * ((match ? kLut12 : 0) + i));
    else return static_cast<uint32_t>(__ldg((match ? dist : lit) + i));
  };

  const int seg = seg0 + tid;
  if (seg < S) {
    const long long lane = row0 + seg;
    const uint32_t sb = static_cast<uint32_t>(seg_bits[lane]);
    const int ov_next =
        seg + 1 < S ? static_cast<int>(static_cast<uint32_t>(seg_bits[lane + 1]) >> 24) : 0;
    int target = min((seg + 1) * kSeg + ov_next, ns[blk]) - seg * kSeg;
    target = min(max(target, 0), kSeg + 255);
    int outp = min(static_cast<int>(sb >> 24), target);
    const int bit = static_cast<int>(sb & 0xFFFFFF);
    const uint32_t row = base + 4 * (lay.table_words + tid * lay.stride);
    const Window win{words, nwords, base + 4 * span_off, static_cast<unsigned>(nspan), span_bit0,
                     gbase};
    // The lane's position, relative to the span's first bit (a multiple of
    // 128, so phases are the same). A step takes tokens while its slots
    // last (slot < slot_end) and a token starts before E, the bit at phase
    // 320 of the step's first row; slot_end = R ends the lane.
    int rel = bit - span_bit0;
    int slot = 0, slot_end = K, E = (rel & ~127) + kMaxPhase + 1;
    bool bad = false;
    // A token's record in its slot, and the step's rules after it; no
    // branch: a token not taken writes the row's pad word and moves nothing.
    const auto put = [&](uint32_t rv, int adv, int len, bool take) {
      sts(row + 4 * (take ? slot : R), rv);
      rel += adv;
      outp += len;
      slot += take;
      const bool end = take && (slot == slot_end || rel >= E);
      slot = end ? slot_end : slot;
      slot_end += end ? K : 0;
      E = end ? (rel & ~127) + kMaxPhase + 1 : E;
    };
    // The scan, with every read of the stream in the staged span (a lane
    // whose whole reach lies in it) or checked.
    const auto scan = [&](auto checked) {
      constexpr bool kChecked = decltype(checked)::value;
      uint64_t x = win.template at<kChecked>(rel);
      while (outp < target && slot < R) {
        // x: bits enough for a match (lit/len code and extra bits, at most
        // 22, then distance code and extra bits, at most 30) or two literals.
        const uint32_t a = lit_at(static_cast<uint32_t>(x) & kMask);
        if ((a & 3) > 1) {
          bad = true;  // EOB inside a segment, or an invalid code
          break;
        }
        const bool match = (a & 3) == 1;
        const int clen = (a >> 2) & 15;
        const int lxb = match ? (a >> 6) & 7 : 0;
        const uint64_t y = x >> (clen + lxb);
        const uint32_t b = second_at(match, static_cast<uint32_t>(y) & kMask);
        if (match && !(b & 1)) {
          bad = true;  // an invalid distance code
          break;
        }
        // A literal consumes no distance bits: dlen = dxb = 0.
        const int dlen = match ? (b >> 1) & 15 : 0;
        const int dxb = match ? (b >> 5) & 15 : 0;
        const int adv = clen + lxb + dlen + dxb;
        // After a literal, b was read where the next token starts: it is taken
        // too if it is a literal and the lane goes on past the first.
        const bool first_ends = slot + 1 == slot_end || rel + adv >= E;
        const bool second = !match && (b & 3) == 0 && outp + 1 < target &&
                            (first_ends ? slot_end : slot + 1) < R;
        const int adv2 = second ? (b >> 2) & 15 : 0;
        // The next token's bits go out before this one's records.
        const uint64_t next = win.template at<kChecked>(rel + adv + adv2);
        const uint32_t dm1 =
            ((b >> 9) & 0x7FFF) + (static_cast<uint32_t>(y >> dlen) & ((1u << dxb) - 1));
        const int len = 3 + static_cast<int>((a >> 9) & 0xFF) +
                        static_cast<int>(static_cast<uint32_t>(x >> clen) & ((1u << lxb) - 1));
        put(match ? outp | dm1 << 10 : outp | 1u << 9 | ((a >> 9) & 0xFF) << 10, adv,
            match ? len : 1, true);
        put(outp | 1u << 9 | ((b >> 9) & 0xFF) << 10, adv2, second, second);
        x = next;
      }
    };
    if (rel >= 0 && static_cast<unsigned>(rel / 32 + reach) < static_cast<unsigned>(nspan))
      scan(std::false_type{});
    else
      scan(std::true_type{});
    outp_out[lane] = outp;
    bad_out[lane] = bad;
  }

  // This warp's rows out, a contiguous run of `rec`, in full lines: rows
  // of a multiple of 4 words as 16-byte chunks (row = v / R4 by a
  // multiply, exact for v < 2^16), others a word at a time.
  __syncwarp();
  const int wseg0 = seg0 + warp * 32;
  const int rows = min(32, S - wseg0);
  if (rows <= 0) return;
  const uint32_t* s = s_rec + warp * 32 * lay.stride;
  uint32_t* g = rec + (row0 + wseg0) * R;
  if ((R & 3) == 0) {
    const int R4 = R >> 2;
    const uint64_t magic = ((1ull << 32) + R4 - 1) / R4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* g4 = reinterpret_cast<uint4*>(g);
#pragma unroll 4
    for (int v = wl; v < rows * R4; v += 32) {
      const int row = static_cast<int>((v * magic) >> 32);
      g4[v] = s4[row * (lay.stride >> 2) + v - row * R4];
    }
  } else {
    for (int v = wl; v < rows * R; v += 32) {
      const int row = v / R;
      g[v] = s[row * lay.stride + v - row * R];
    }
  }
}

}  // namespace

// Dynamic shared memory a launch at (lut_bits, K, rsteps) takes, bytes; 0
// when K * rsteps is too large for the staged rows.
extern "C" int compu_inflate_scan_smem(int lut_bits, int K, int rsteps) {
  const Layout l = make_layout(lut_bits, K, rsteps);
  return l.span_words ? l.bytes() : 0;
}

// comps: (B, cap) u8, 16-byte aligned, cap a multiple of 16; seg_bits: (B,
// S) i32; ns: (B,) i32; lit_lut, dist_lut: (B, 2^lut_bits) i32, 16-byte
// aligned, lut_bits 12 or 15; rec: (B * S, K * rsteps) i32, 16-byte
// aligned; outp: (B * S,) i32; bad: (B * S,) bool.
extern "C" int compu_inflate_scan(const void* comps, long long cap, int B, const void* seg_bits,
                                  int S, const void* ns, const void* lit_lut,
                                  const void* dist_lut, int lut_bits, int K, int rsteps,
                                  void* rec, void* outp, void* bad, void* stream) {
  const Layout lay = make_layout(lut_bits, K, rsteps);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (cap % 16 || !aligned(comps) || !aligned(lit_lut) || !aligned(dist_lut) || !aligned(rec) ||
      B < 1 || B > 65535 || S < 1 || K < 1 || rsteps < 1 || !lay.span_words ||
      (lut_bits != 12 && lut_bits != 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = lut_bits == 12 ? inflate_scan_kernel<12> : inflate_scan_kernel<15>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kLanes - 1) / kLanes, B);
  kernel<<<grid, kLanes, lay.bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(comps), static_cast<long long>(B) * cap / 4, cap * 8,
      static_cast<const int32_t*>(seg_bits), S, static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(lit_lut), static_cast<const int32_t*>(dist_lut), K, rsteps,
      lay, static_cast<uint32_t*>(rec), static_cast<int32_t*>(outp),
      static_cast<uint8_t*>(bad));
  return static_cast<int>(cudaGetLastError());
}
