// Hash-bucket match candidates over hash-sorted window lanes.
//
// Replaces: compu_tpu/kernels/match_pallas.py:_match_kernel (via
// match_candidates_pallas). Plain twin:
// compu_tpu_torch/kernels/match_candidates.py match_candidates_torch.
//
// For every sorted lane i and d = 1..depth, lane i-d is a candidate when it
// lies in the same block (lpos >= d), has the same 3-byte hash, and is
// 0 < dist <= max_dist behind, dist = ps[i] - ps[i-d]. Its length is the
// count of equal leading bytes of the two little-endian windows: trailing
// zero bytes of the XOR, word by word, word k counting only while words
// 0..k-1 matched in full. A later d replaces the best only on a strictly
// longer length, so equal lengths keep the nearest lane in sort order. Any
// order of hs is taken; buckets need not be contiguous.
//
// Bound on the H100: memory at depth 16 with 8 window words (201 MB for 4 M
// lanes, 0.060 ms), the integer pipe at depth 32 with 4 (808 M operations
// by chip_smoke.py's count, 0.048 ms). Each lane reads (2 + nwords) 32-bit
// values and writes two. On the benchmark corpus 62-74% of the in-block
// candidates are matches (equal hash, distance in range); 94% of those
// differ within their first two words.
//
// Design. A block takes a tile of 512 lanes, 4 consecutive lanes a thread,
// with a backward halo of round_up(depth, 4) lanes. hs, ps and the word
// rows arrive by 16-byte cp.async copies (zero-filled outside the array) in
// two groups: the rows phase A reads, then the other words, which land
// while phase A runs. Indices inside a tile are 32-bit.
//
// Phase A walks each thread's neighbours 4 at a time, as lcp_candidates.cu
// does: one 16-byte shared load per row and step serves 16 candidates.
// Each candidate, without branches, builds one key from its first two
// words: with X the 64-bit XOR of words 0 and 1, (X - 1) & ~X & 0x8080...80
// flags the trailing zero bytes of X, so
//   code = flags.hi + (flags.lo >> 1)
// sets one bit per matched byte (bits 6, 7, 14, 15, ...) and is monotone in
// the length; bits 0-5 hold 63 - (d - 1 - chunk base). Two compares and a
// predicated unsigned max keep the key of a match: longer wins, then the
// smaller d, the reference's order. No XU instruction runs in phase A; the
// length is popc(code), for the winner only.
//
// Phase B takes the matches whose first two words are equal (the key's top
// bit, shifted into a 32-bit mask per lane and chunk of 32 d; 4-6% of the
// matches) and compares words 2..nwords-1 one by one; its key is
// 0xC0C0C0C0 + (len - 8) * 64 + the same d term, above every phase A key.
// Depths above 32 run in chunks of 32 d, merged on the length alone so that
// the earlier chunk keeps a tie. Phase B's matches are few but bunched, and
// a warp waits for its busiest thread: it is what holds the kernel back
// (PERF.md).
//
// Block starts: a thread whose lanes lie within depth of their block's
// start replaces, in registers, the ps of neighbours before that start
// with the largest ps of its own lanes, so their distance is <= 0 and they
// fail the range test; the other threads test nothing. Needs
// block_elems >= 4 (4 lanes of a thread in one block); smaller blocks run
// the generic instance, which tests lpos >= d per candidate.
//
// depth and nwords are template parameters for the level ladder's depths
// (4, 6, 8, 12, 16, 24, 32, 48) and 2, 4 or 8 words (wcap 8, 16, 32), which
// unrolls the walk; the generic instance takes any depth >= 1 and 1..8
// words at run time (for 1 word the second word compares as unequal).
// Shared memory is sized at launch: (2 + max(nwords, 2)) * (512 +
// round_up(depth, 4)) 32-bit values, opted in above 48 KB. Distances are
// taken in 32-bit arithmetic: positions must differ by less than 2^31 -
// max_dist.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                    // consecutive lanes per thread
constexpr int kTile = kThreads * kLanes;     // lanes per block
constexpr int kChunkGroups = 8;              // 32 d per key chunk and mask
constexpr int kMaxWords = 8;
constexpr size_t kDefaultSmem = 48 * 1024;   // above this, opt in per kernel
constexpr uint32_t kBoth = 0xC0C0C0C0u;      // code of two equal words

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void unpack(int4 v, int (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// a & ~b & c in one instruction.
__device__ __forceinline__ uint32_t and_not_and(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x20;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// One bit per equal leading byte of the two words whose XORs are x0, x1:
// bits 6, 14, 22, 30 for word 0, then 7, 15, 23, 31 for word 1, each set
// only while every earlier byte is equal; plus dterm (< 64). Each word's
// (X - 1) & ~X & 0x80808080 is one three-input logic op.
__device__ __forceinline__ uint32_t two_word_key(uint32_t x0, uint32_t x1, uint32_t dterm) {
  const uint64_t x = (static_cast<uint64_t>(x1) << 32) | x0;
  const uint64_t xm1 = x - 1;
  const uint32_t tops = 0x80808080u;
  const uint32_t lo = and_not_and(static_cast<uint32_t>(xm1), x0, tops);
  const uint32_t hi = and_not_and(static_cast<uint32_t>(xm1 >> 32), x1, tops);
  return hi + (lo >> 1) + dterm;
}

// best = max(best, key) where the candidate is a match: equal hashes and
// t (max_dist - dist) below max_dist: two compares, a predicated max and a
// select (the same in C++ compiles to one compare and one select more).
// Returns key for a match, else 0.
__device__ __forceinline__ uint32_t keep_if_match(uint32_t& best, uint32_t key, uint32_t t,
                                                  int max_dist, int h, int nh) {
  uint32_t kept;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.u32 p, %3, %4;\n\t"
      "setp.eq.and.s32 p, %5, %6, p;\n\t"
      "@p max.u32 %0, %0, %2;\n\t"
      "selp.b32 %1, %2, 0, p;\n\t}"
      : "+r"(best), "=r"(kept)
      : "r"(key), "r"(t), "r"(max_dist), "r"(h), "r"(nh));
  return kept;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy rows r0..r1-1 (hs, ps, then the words) of a tile and its halo,
// from global lane g0, into s: 16-byte copies where n % 4 == 0 and the rows
// are aligned, else plain 4-byte loads and stores.
__device__ __forceinline__ void stage_rows(int32_t* s, int span, int r0, int r1,
                                           const int32_t* hs, const int32_t* ps,
                                           const int32_t* words, long long n,
                                           long long g0, bool vec) {
  if (vec) {
    const int chunks = span / 4;
    for (int t = threadIdx.x; t < (r1 - r0) * chunks; t += kThreads) {
      const int r = r0 + t / chunks, j = 4 * (t % chunks);
      const long long g = g0 + j;
      const bool valid = g >= 0 && g < n;  // n % 4 == 0: all 4 or none
      const int32_t* row = r == 0 ? hs : r == 1 ? ps : words + (r - 2) * n;
      cp_async16(s + r * span + j, valid ? row + g : row, valid);
    }
  } else {
    for (int t = threadIdx.x; t < (r1 - r0) * span; t += kThreads) {
      const int r = r0 + t / span, j = t % span;
      const long long g = g0 + j;
      const int32_t* row = r == 0 ? hs : r == 1 ? ps : words + (r - 2) * n;
      s[r * span + j] = g >= 0 && g < n ? row[g] : 0;
    }
  }
}

// DEPTH, NW > 0: compile-time depth and word count; both 0: the generic
// instance, with depth_rt and nw_rt.
template <int DEPTH, int NW>
__global__ void __launch_bounds__(kThreads)
    match_kernel(const int32_t* __restrict__ hs, const int32_t* __restrict__ ps,
                 const int32_t* __restrict__ words, int nw_rt,
                 int32_t* __restrict__ best_len, int32_t* __restrict__ best_dist,
                 long long n, long long block_mask, int depth_rt, int max_dist,
                 bool vec) {
  constexpr bool kGeneric = DEPTH == 0;
  const int depth = kGeneric ? depth_rt : DEPTH;
  const int nw = kGeneric ? nw_rt : NW;
  const int groups = (depth + 3) / 4;
  const int halo = 4 * groups;
  const int span = kTile + halo;
  extern __shared__ int4 smem4[];
  // Rows of span values: hs, ps, then the words; one word adds a zero row.
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long g0 = tile0 - halo;  // global lane of shared index 0

  // Two copy groups: hs, ps and words 0-1, which phase A reads, then the
  // other words, which only phase B reads and which land during phase A.
  const int rows = 2 + nw, early = rows < 4 ? rows : 4;
  stage_rows(s, span, 0, early, hs, ps, words, n, g0, vec);
  cp_async_commit();
  stage_rows(s, span, early, rows, hs, ps, words, n, g0, vec);
  cp_async_commit();
  if (nw == 1) {
    for (int j = threadIdx.x; j < span; j += kThreads) s[3 * span + j] = 0;
  }
  cp_async_wait_one();
  __syncthreads();

  const int4* h4 = reinterpret_cast<const int4*>(s);
  const int4* p4 = reinterpret_cast<const int4*>(s + span);
  const int4* a4 = reinterpret_cast<const int4*>(s + 2 * span);
  const int4* b4 = reinterpret_cast<const int4*>(s + 3 * span);
  const int c4 = groups + threadIdx.x;  // chunk of the thread's own lanes
  const int own = 4 * c4;               // shared index of lane 0
  const long long i0 = tile0 + kLanes * threadIdx.x;

  // The "hi" chunk holds the 4 lanes after the "lo" one loaded each step.
  int Hh[4], Ph[4], Ah[4], Bh[4];
  unpack(h4[c4], Hh);
  unpack(p4[c4], Ph);
  unpack(a4[c4], Ah);
  unpack(b4[c4], Bh);
  int h[4], dlim[4];
  uint32_t base[4], w0[4], w1[4], okey[4], obase[4];
  const long long lpos0 = i0 & block_mask;
  const int pmax = max(max(Ph[0], Ph[1]), max(Ph[2], Ph[3]));
  // Shared index of the first lane of the thread's block (block_elems >= 4).
  const long long first_ll = i0 - lpos0 - g0;
  const int first = first_ll < 0 ? -1 : static_cast<int>(first_ll);
  const bool edge = lpos0 < depth;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    h[q] = Hh[q];
    // base + ps[j] is max_dist - dist (mod 2^32).
    base[q] = static_cast<uint32_t>(max_dist) - static_cast<uint32_t>(Ph[q]);
    w0[q] = static_cast<uint32_t>(Ah[q]);
    w1[q] = static_cast<uint32_t>(Bh[q]) ^ (nw == 1 ? 1u : 0u);
    okey[q] = 0;
    obase[q] = 0;
    if (kGeneric) {
      const long long lp = (i0 + q) & block_mask;
      dlim[q] = lp < depth ? static_cast<int>(lp) : depth;
    }
  }

#pragma unroll(DEPTH > 0 ? (DEPTH + 31) / 32 : 1)
  for (int cb = 0; cb < groups; cb += kChunkGroups) {
    uint32_t best[4] = {0, 0, 0, 0}, mask[4] = {0, 0, 0, 0};
    const int gend = min(cb + kChunkGroups, groups);
#pragma unroll(DEPTH > 0 ? kChunkGroups : 1)
    for (int g = cb; g < gend; ++g) {
      int Hl[4], Pl[4], Al[4], Bl[4];
      unpack(h4[c4 - g - 1], Hl);
      unpack(p4[c4 - g - 1], Pl);
      unpack(a4[c4 - g - 1], Al);
      unpack(b4[c4 - g - 1], Bl);
      if (!kGeneric && edge) {
        // Neighbours before the block start: distance <= 0 for every lane.
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * (c4 - g - 1) + k < first) Pl[k] = pmax;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int d = 4 * g + 1 + r;
        if (d <= depth) {
          const int b = d - 1 - 4 * cb;  // bit of d in the chunk, 0..31
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // Neighbour q - d: lane q-r-1 of the hi chunk, or of the lo one.
            const int ip = q - r - 1;
            const int nh = ip >= 0 ? Hh[ip] : Hl[4 + ip];
            const int np = ip >= 0 ? Ph[ip] : Pl[4 + ip];
            const uint32_t n0 = static_cast<uint32_t>(ip >= 0 ? Ah[ip] : Al[4 + ip]);
            const uint32_t n1 = static_cast<uint32_t>(ip >= 0 ? Bh[ip] : Bl[4 + ip]);
            // base + ps[j] is max_dist - dist: in range below max_dist.
            uint32_t t = base[q] + static_cast<uint32_t>(np);
            if (kGeneric && d > dlim[q]) t = static_cast<uint32_t>(max_dist);
            const uint32_t key = two_word_key(w0[q] ^ n0, w1[q] ^ n1, 63 - b);
            if (NW == 2) {
              keep_if_match(best[q], key, t, max_dist, h[q], nh);
            } else {
              // Append to the mask whether this is a match whose first two
              // words are equal (the key's top bit).
              mask[q] = __funnelshift_l(keep_if_match(best[q], key, t, max_dist, h[q], nh),
                                        mask[q], 1);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Hh[k] = Hl[k];
        Ph[k] = Pl[k];
        Ah[k] = Al[k];
        Bh[k] = Bl[k];
      }
    }

    // Phase B: words 2.. of the candidates whose first two words are equal.
    if (NW == 0 || NW > 2) {
      if (cb == 0) {
        cp_async_wait_all();  // the late rows
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // Bit i of the mask is the candidate walked i steps before the
        // chunk's last: b = dn - 1 - i.
        const int dn = min(4 * kChunkGroups, depth - 4 * cb);
        uint32_t m = mask[q];
        while (m) {
          const int b = dn - __ffs(m);
          m &= m - 1;
          const int j = own + q - (4 * cb + b + 1);
          int l = 8;
#pragma unroll
          for (int k = 2; k < (NW > 0 ? NW : kMaxWords); ++k) {
            if (k >= nw) break;
            const uint32_t x = static_cast<uint32_t>(s[(2 + k) * span + own + q] ^
                                                     s[(2 + k) * span + j]);
            if (x) {
              l += (__ffs(x) - 1) >> 3;
              break;
            }
            l += 4;
          }
          best[q] = max(best[q], kBoth + ((l - 8) << 6) + (63 - b));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // Longer only: on equal length the earlier chunk (smaller d) stays.
      if ((best[q] & ~63u) > (okey[q] & ~63u)) {
        okey[q] = best[q];
        obase[q] = 4 * cb;
      }
    }
  }

  int bl[4], bd[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t c = okey[q] & ~63u;
    bl[q] = c >= kBoth ? 8 + static_cast<int>((c - kBoth) >> 6) : __popc(c);
    const int d = static_cast<int>(obase[q]) + 64 - static_cast<int>(okey[q] & 63);
    const uint32_t dist = static_cast<uint32_t>(s[span + own + q]) -
                          static_cast<uint32_t>(s[span + own + q - d]);
    bd[q] = bl[q] > 0 ? static_cast<int>(dist) : 0;
  }
  if (vec) {
    if (i0 < n) {
      *reinterpret_cast<int4*>(best_len + i0) = make_int4(bl[0], bl[1], bl[2], bl[3]);
      *reinterpret_cast<int4*>(best_dist + i0) = make_int4(bd[0], bd[1], bd[2], bd[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q < n) {
        best_len[i0 + q] = bl[q];
        best_dist[i0 + q] = bd[q];
      }
    }
  }
}

template <int DEPTH, int NW>
cudaError_t launch(const int32_t* hs, const int32_t* ps, const int32_t* words,
                   int nwords, int32_t* best_len, int32_t* best_dist,
                   long long n, long long block_elems, int depth, int max_dist,
                   bool vec, cudaStream_t stream) {
  const int span = kTile + 4 * ((depth + 3) / 4);
  const size_t smem =
      static_cast<size_t>(2 + (nwords > 2 ? nwords : 2)) * span * sizeof(int32_t);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        match_kernel<DEPTH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  match_kernel<DEPTH, NW><<<blocks, kThreads, smem, stream>>>(
      hs, ps, words, nwords, best_len, best_dist, n, block_elems - 1, depth,
      max_dist, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// hs, ps, best_len, best_dist: (n,) i32; words: (nwords, n) u32 bit patterns.
// block_elems is a power of two dividing n; 1 <= nwords <= 8; depth >= 1;
// 0 <= max_dist. The template instances are the ladder's depths with 2, 4
// or 8 words and block_elems >= 4 (kernels/match_candidates.py
// kernel_instance mirrors this table); everything else runs the generic one.
extern "C" int compu_match_candidates(const void* hs, const void* ps,
                                      const void* words, int nwords,
                                      void* best_len, void* best_dist,
                                      long long n, long long block_elems,
                                      int depth, int max_dist, void* stream) {
  if (nwords < 1 || nwords > kMaxWords || depth < 1 || max_dist < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto h = static_cast<const int32_t*>(hs);
  auto p = static_cast<const int32_t*>(ps);
  auto w = static_cast<const int32_t*>(words);
  auto bl = static_cast<int32_t*>(best_len);
  auto bd = static_cast<int32_t*>(best_dist);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(h) && aligned16(p) && aligned16(w) &&
                   aligned16(bl) && aligned16(bd);
  const int key = block_elems >= 4 ? nwords * 1000 + depth : 0;
  cudaError_t err;
  switch (key) {
#define COMPU_MATCH(D, W)                                                     \
  case W * 1000 + D:                                                          \
    err = launch<D, W>(h, p, w, nwords, bl, bd, n, block_elems, depth,        \
                       max_dist, vec, s);                                     \
    break;
#define COMPU_MATCH_DEPTHS(W)                                                 \
  COMPU_MATCH(4, W)                                                           \
  COMPU_MATCH(6, W)                                                           \
  COMPU_MATCH(8, W)                                                           \
  COMPU_MATCH(12, W)                                                          \
  COMPU_MATCH(16, W)                                                          \
  COMPU_MATCH(24, W)                                                          \
  COMPU_MATCH(32, W)                                                          \
  COMPU_MATCH(48, W)
    COMPU_MATCH_DEPTHS(2)
    COMPU_MATCH_DEPTHS(4)
    COMPU_MATCH_DEPTHS(8)
#undef COMPU_MATCH_DEPTHS
#undef COMPU_MATCH
    default:
      err = launch<0, 0>(h, p, w, nwords, bl, bd, n, block_elems, depth,
                         max_dist, vec, s);
  }
  return static_cast<int>(err);
}
