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
// Bound on the H100: latency. A token's table reads depend on the
// previous token's length (the lit/len read, then the distance read at an
// offset it gives), so a lane is a chain of dependent table reads; a
// batch has B * S lanes (32,768 for 16 blocks of 256 KiB), about eight
// warps an SM. Device-memory traffic is each lane's span of the stream,
// the tables and the records (K * rsteps words a lane), once.
//
// Design (a simple one): a thread a lane; a CUDA block holds 128 lanes of
// one deflate block, so the 12-bit tables (2 x 16 KiB) are staged in
// shared memory once a block; the 15-bit tables (2 x 128 KiB) are read
// from device memory through the read-only cache. The stream bits sit in
// a 64-bit container refilled with a 32-bit word whenever fewer than 32
// bits are left, before the lit/len read and before the distance read (a
// token takes at most 15 + 5 bits, then 15 + 13). Records are written as
// the lane goes, one 32-bit store a slot.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 128;
constexpr int kNoToken = 511;
constexpr int kMaxPhase = 319;
constexpr int kThreads = 128;

// The lane's stream bits, LSB first, over the batch's 32-bit words.
struct BitIn {
  const uint32_t* words;
  long long nwords;
  long long next;  // the next word to load
  uint64_t buf;    // bits from the current position; n of them valid
  int n;

  __device__ __forceinline__ uint32_t load(long long q) const {
    return q < nwords ? __ldg(words + q) : 0u;
  }
  __device__ __forceinline__ void init(long long gbit) {
    const long long q = gbit >> 5;
    const int sh = static_cast<int>(gbit & 31);
    buf = static_cast<uint64_t>(load(q) >> sh);
    n = 32 - sh;
    next = q + 1;
  }
  // At least 32 valid bits afterwards.
  __device__ __forceinline__ void fill() {
    if (n < 32) {
      buf |= static_cast<uint64_t>(load(next++)) << n;
      n += 32;
    }
  }
  __device__ __forceinline__ void skip(int k) {
    buf >>= k;
    n -= k;
  }
};

template <int kBits, bool kShared>
__global__ void __launch_bounds__(kThreads) inflate_scan_kernel(
    const uint32_t* __restrict__ words, long long nwords, long long block_bits,
    const int32_t* __restrict__ seg_bits, int S, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ lit_lut, const int32_t* __restrict__ dist_lut, int K,
    int rsteps, int32_t* __restrict__ rec, int32_t* __restrict__ outp_out,
    uint8_t* __restrict__ bad_out) {
  constexpr int kLut = 1 << kBits;
  constexpr uint32_t kMask = kLut - 1;
  __shared__ int32_t s_lut[kShared ? 2 * kLut : 1];
  const int blk = blockIdx.y;
  const int seg = blockIdx.x * kThreads + threadIdx.x;
  const int32_t* lit = lit_lut + static_cast<long long>(blk) * kLut;
  const int32_t* dist = dist_lut + static_cast<long long>(blk) * kLut;
  if constexpr (kShared) {
#pragma unroll 8
    for (int i = threadIdx.x; i < kLut; i += kThreads) {
      s_lut[i] = __ldg(lit + i);
      s_lut[kLut + i] = __ldg(dist + i);
    }
    __syncthreads();
  }
  if (seg >= S) return;
  // The table reads: LDS from the staged copy, or read-only global loads.
  const auto lit_at = [&](uint32_t i) -> int {
    if constexpr (kShared) return s_lut[i];
    else return __ldg(lit + i);
  };
  const auto dist_at = [&](uint32_t i) -> int {
    if constexpr (kShared) return s_lut[kLut + i];
    else return __ldg(dist + i);
  };

  const long long lane = static_cast<long long>(blk) * S + seg;
  const uint32_t sb = static_cast<uint32_t>(seg_bits[lane]);
  const int ov_next = seg + 1 < S ? static_cast<int>(static_cast<uint32_t>(seg_bits[lane + 1]) >> 24)
                                  : 0;
  int target = min((seg + 1) * kSeg + ov_next, ns[blk]) - seg * kSeg;
  target = min(max(target, 0), kSeg + 255);
  int outp = min(static_cast<int>(sb >> 24), target);
  int bit = static_cast<int>(sb & 0xFFFFFF);

  const int R = K * rsteps;
  int32_t* r = rec + lane * R;
  BitIn in{words, nwords, 0, 0, 0};
  in.init(blk * block_bits + bit);
  bool bad = false;
  int slot = 0;
  for (int t = 0; t < rsteps && outp < target && !bad; ++t) {
    int ph = bit & 127;
    int k = 0;
    for (; k < K && ph <= kMaxPhase && outp < target; ++k) {
      in.fill();
      const int a = lit_at(static_cast<uint32_t>(in.buf) & kMask);
      const int kind = a & 3;
      const int clen = (a >> 2) & 15;
      int adv, len, rv;
      if (kind == 0) {
        rv = outp | 1 << 9 | ((a >> 9) & 0xFF) << 10;
        adv = clen;
        len = 1;
        in.skip(clen);
      } else if (kind == 1) {
        const int lxb = (a >> 6) & 7;
        len = 3 + ((a >> 9) & 0xFF) +
              static_cast<int>(static_cast<uint32_t>(in.buf >> clen) & ((1u << lxb) - 1));
        in.skip(clen + lxb);
        in.fill();
        const int d = dist_at(static_cast<uint32_t>(in.buf) & kMask);
        if (!(d & 1)) {
          bad = true;
          break;
        }
        const int dlen = (d >> 1) & 15;
        const int dxb = (d >> 5) & 15;
        const int dm1 = ((d >> 9) & 0x7FFF) +
                        static_cast<int>(static_cast<uint32_t>(in.buf >> dlen) & ((1u << dxb) - 1));
        in.skip(dlen + dxb);
        rv = outp | dm1 << 10;
        adv = clen + lxb + dlen + dxb;
      } else {
        bad = true;  // EOB inside a segment, or an invalid code
        break;
      }
      r[slot + k] = rv;
      bit += adv;
      ph += adv;
      outp += len;
    }
    for (; k < K; ++k) r[slot + k] = kNoToken;
    slot += K;
  }
  for (; slot < R; ++slot) r[slot] = kNoToken;
  outp_out[lane] = outp;
  bad_out[lane] = bad;
}

}  // namespace

// comps: (B, cap) u8, 16-byte aligned, cap a multiple of 16; seg_bits: (B,
// S) i32; ns: (B,) i32; lit_lut, dist_lut: (B, 2^lut_bits) i32, lut_bits 12
// or 15; rec: (B * S, K * rsteps) i32; outp: (B * S,) i32; bad: (B * S,)
// bool.
extern "C" int compu_inflate_scan(const void* comps, long long cap, int B, const void* seg_bits,
                                  int S, const void* ns, const void* lit_lut,
                                  const void* dist_lut, int lut_bits, int K, int rsteps,
                                  void* rec, void* outp, void* bad, void* stream) {
  if (cap % 16 || reinterpret_cast<uintptr_t>(comps) % 16 || B < 1 || B > 65535 || S < 1 ||
      K < 1 || rsteps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(comps);
  const long long nwords = static_cast<long long>(B) * cap / 4;
  const auto* sb = static_cast<const int32_t*>(seg_bits);
  const auto* n = static_cast<const int32_t*>(ns);
  const auto* lit = static_cast<const int32_t*>(lit_lut);
  const auto* dist = static_cast<const int32_t*>(dist_lut);
  auto* r = static_cast<int32_t*>(rec);
  auto* o = static_cast<int32_t*>(outp);
  auto* b = static_cast<uint8_t*>(bad);
  if (lut_bits == 12)
    inflate_scan_kernel<12, true><<<grid, kThreads, 0, st>>>(w, nwords, cap * 8, sb, S, n, lit,
                                                             dist, K, rsteps, r, o, b);
  else if (lut_bits == 15)
    inflate_scan_kernel<15, false><<<grid, kThreads, 0, st>>>(w, nwords, cap * 8, sb, S, n, lit,
                                                              dist, K, rsteps, r, o, b);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
