// LCP match candidates over lexicographically sorted window lanes.
//
// Replaces: compu_tpu/kernels/lcp_match.py:_lcp_kernel (via
// lcp_candidates_pallas). Plain twin: compu_tpu_torch/kernels/lcp_match.py
// lcp_candidates_torch.
//
// For every sorted lane i: adj[i] = equal leading bytes of the window words
// of lanes i-1 and i (0 at a block start). The LCP to neighbour i-d is
// min(adj[i-d+1..i]) and to i+d is min(adj[i+1..i+d]); the best (len, dist)
// with 0 < dist <= max_dist wins, the nearer distance on equal length, or
// the farther one with prefer_far (the reference kernel's COMPU_LCP_TIE=far,
// lcp_match.py:229). Neighbours never cross a block of block_elems lanes.
//
// Bound on the H100: memory, with the ALU pipe close behind. Each lane
// reads nwords + 1 words and writes 2, and weighs 2*depth candidates; a
// candidate compiles to about 3.6 ALU-pipe instructions (running min,
// range test, select, max) and 2 on the FMA pipe (the add, the key). At
// depth 16 that is ~115 ALU instructions per 28 bytes, near the card's
// ~5 INT32 operations per byte of device memory, so every ALU instruction
// taken off a candidate shows in the time.
//
// Design: one launch; adj never leaves shared memory. A block takes a tile
// of 1,024 lanes, 4 consecutive lanes a thread, with a halo of
// round_up(depth, 4) lanes on each side. The words and ps of the tile and
// halo arrive by 16-byte cp.async copies (zero-filled outside the array),
// then adj is computed in shared memory. Each thread walks its 4 lanes'
// neighbours 4 at a time: one 16-byte shared load of adj and one of ps per
// direction and step feed 16 candidates, the 4 lanes sharing the loads.
// depth is a template parameter for the level ladder's values (4, 6, 8, 12,
// 16, 24, 32, 48), which unrolls the walk; any other depth in 1..127 runs
// the same code with a runtime step count.
//
// Block edges cost nothing: adj is 0 at every block start and outside the
// array, so a running min that reaches past its block is 0 and the
// candidate cannot win. No lane tests its position in the block.
//
// A candidate is one packed key, (len << 24) | t, kept by a max. For the
// nearer rule t = max_dist - dist, so the order of keys is the order of
// "longer, then nearer"; for the farther rule (template parameter FAR, its
// own instantiations) t = dist - 1, "longer, then farther". Either way the
// max over all candidates is the twin's sequential choice, whatever the
// order, and a distance in (0, max_dist] is exactly (unsigned)t < max_dist,
// one compare; a candidate out of range offers the key 0. Both t are one
// add from the lane's base and the neighbour's position, so the two rules
// cost the same. Needs max_dist <= 2^24 (the wrapper checks).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // consecutive lanes per thread
constexpr int kTile = kThreads * kLanes;    // lanes per block
constexpr size_t kDefaultSmem = 48 * 1024;  // above this, opt in per kernel

__device__ __forceinline__ int lead_zero_bytes(uint32_t x) {
  return __clz(x) >> 3;  // __clz(0) == 32, so 0 gives 4
}

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

// One candidate: running LCP l, neighbour position q, for a lane whose
// base is max_dist - p (nearer rule) or p - 1 (FAR).
template <bool FAR>
__device__ __forceinline__ void consider(int l, int q, int base, int max_dist,
                                         int& best) {
  const int t = FAR ? base - q : base + q;  // dist - 1 : max_dist - dist
  // t < 2^24 where it is kept, so l * 2^24 + t is (l << 24) | t: one IMAD,
  // on the FMA pipe, beside the ALU's compare, select and max.
  const int key = l * (1 << 24) + t;
  best = max(best, static_cast<unsigned>(t) < static_cast<unsigned>(max_dist)
                       ? key
                       : 0);
}

// DEPTH > 0: compile-time depth; DEPTH == 0: runtime depth. FAR: equal
// lengths take the farther distance.
template <int DEPTH, bool FAR>
__global__ void __launch_bounds__(kThreads)
    lcp_kernel(const int32_t* __restrict__ words, int nwords,
               const int32_t* __restrict__ ps, int32_t* __restrict__ best_len,
               int32_t* __restrict__ best_dist, long long n,
               long long block_mask, int depth_rt, int max_dist, bool vec) {
  const int depth = DEPTH > 0 ? DEPTH : depth_rt;
  const int groups = (depth + 3) / 4;
  const int halo = 4 * groups;
  const int span = kTile + 2 * halo;
  extern __shared__ int4 smem4[];
  int32_t* s_words = reinterpret_cast<int32_t*>(smem4);  // (nwords, span)
  int32_t* s_ps = s_words + nwords * span;
  int32_t* s_adj = s_ps + span;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long g0 = tile0 - halo;  // global lane of shared index 0

  // Stage the word rows and ps of the tile and its halo.
  if (vec) {
    const int chunks = span / 4;
    for (int t = threadIdx.x; t < (nwords + 1) * chunks; t += kThreads) {
      const int r = t / chunks, j = 4 * (t - r * chunks);
      const long long g = g0 + j;
      const bool valid = g >= 0 && g < n;  // n % 4 == 0: all 4 or none
      const int32_t* row = r < nwords ? words + r * n : ps;
      int32_t* dst = r < nwords ? s_words + r * span : s_ps;
      cp_async16(dst + j, valid ? row + g : row, valid);
    }
    cp_async_wait_all();
  } else {
    for (int t = threadIdx.x; t < (nwords + 1) * span; t += kThreads) {
      const int r = t / span, j = t - r * span;
      const long long g = g0 + j;
      const bool valid = g >= 0 && g < n;
      const int32_t* row = r < nwords ? words + r * n : ps;
      int32_t* dst = r < nwords ? s_words + r * span : s_ps;
      dst[j] = valid ? row[g] : 0;
    }
  }
  __syncthreads();

  // adj in shared memory: 0 at a block start and outside the array.
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const long long g = g0 + j;
    int l = 0;
    if (j > 0 && g > 0 && g < n && (g & block_mask) != 0) {
      l = lead_zero_bytes(static_cast<uint32_t>(s_words[j] ^ s_words[j - 1]));
      for (int k = 1; k < nwords; ++k) {
        const int lk = lead_zero_bytes(static_cast<uint32_t>(
            s_words[k * span + j] ^ s_words[k * span + j - 1]));
        l += l == 4 * k ? lk : 0;
      }
    }
    s_adj[j] = l;
  }
  __syncthreads();

  // Walk the neighbours of the thread's 4 lanes, 4 steps at a time.
  const int4* adj4 = reinterpret_cast<const int4*>(s_adj);
  const int4* ps4 = reinterpret_cast<const int4*>(s_ps);
  const int c4 = groups + threadIdx.x;  // chunk of the thread's own lanes
  int p[4], base[4], best[4], mb[4], mf[4];
  int a_hi[4], pa_hi[4], f_lo[4], pf_lo[4], f_hi[4], pf_hi[4];
  unpack(adj4[c4], a_hi);
  unpack(ps4[c4], pa_hi);
  unpack(adj4[c4 + 1], f_hi);
  unpack(ps4[c4 + 1], pf_hi);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p[q] = pa_hi[q];
    base[q] = FAR ? p[q] - 1 : max_dist - p[q];
    best[q] = 0;
    mb[q] = INT_MAX;
    mf[q] = INT_MAX;
    f_lo[q] = a_hi[q];
    pf_lo[q] = pa_hi[q];
  }

#pragma unroll(DEPTH > 0 ? (DEPTH + 3) / 4 : 1)
  for (int g = 0; g < groups; ++g) {
    int a_lo[4], pa_lo[4];
    unpack(adj4[c4 - g - 1], a_lo);
    unpack(ps4[c4 - g - 1], pa_lo);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (4 * g + 1 + r <= depth) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // Backward, d = 4g+1+r: adj of lane q-d+1, ps of lane q-d.
          const int ia = q - r, ip = q - r - 1;
          mb[q] = min(mb[q], ia >= 0 ? a_hi[ia] : a_lo[4 + ia]);
          consider<FAR>(mb[q], ip >= 0 ? pa_hi[ip] : pa_lo[4 + ip], base[q],
                        max_dist, best[q]);
          // Forward: adj and ps of lane q+d.
          const int i = q + 1 + r;
          mf[q] = min(mf[q], i < 4 ? f_lo[i] : f_hi[i - 4]);
          consider<FAR>(mf[q], i < 4 ? pf_lo[i] : pf_hi[i - 4], base[q],
                        max_dist, best[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a_hi[q] = a_lo[q];
      pa_hi[q] = pa_lo[q];
      f_lo[q] = f_hi[q];
      pf_lo[q] = pf_hi[q];
    }
    if (g + 1 < groups) {
      unpack(adj4[c4 + g + 2], f_hi);
      unpack(ps4[c4 + g + 2], pf_hi);
    }
  }

  int bl[4], bd[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bl[q] = best[q] >> 24;
    const int t = best[q] & 0xFFFFFF;
    bd[q] = bl[q] > 0 ? (FAR ? t + 1 : max_dist - t) : 0;
  }
  const long long i0 = tile0 + kLanes * threadIdx.x;
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

template <int DEPTH, bool FAR>
cudaError_t launch(const int32_t* words, int nwords, const int32_t* ps,
                   int32_t* best_len, int32_t* best_dist, long long n,
                   long long block_elems, int depth, int max_dist, bool vec,
                   cudaStream_t stream) {
  const int span = kTile + 8 * ((depth + 3) / 4);
  const size_t smem = static_cast<size_t>(nwords + 2) * span * sizeof(int32_t);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        lcp_kernel<DEPTH, FAR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  lcp_kernel<DEPTH, FAR><<<blocks, kThreads, smem, stream>>>(
      words, nwords, ps, best_len, best_dist, n, block_elems - 1, depth,
      max_dist, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool FAR>
cudaError_t dispatch(const int32_t* w, int nwords, const int32_t* p,
                     int32_t* bl, int32_t* bd, long long n,
                     long long block_elems, int depth, int max_dist, bool vec,
                     cudaStream_t s) {
  switch (depth) {
#define COMPU_LCP_DEPTH(D) \
  case D:                  \
    return launch<D, FAR>(w, nwords, p, bl, bd, n, block_elems, depth, max_dist, vec, s);
    COMPU_LCP_DEPTH(4)
    COMPU_LCP_DEPTH(6)
    COMPU_LCP_DEPTH(8)
    COMPU_LCP_DEPTH(12)
    COMPU_LCP_DEPTH(16)
    COMPU_LCP_DEPTH(24)
    COMPU_LCP_DEPTH(32)
    COMPU_LCP_DEPTH(48)
#undef COMPU_LCP_DEPTH
    default:
      return launch<0, FAR>(w, nwords, p, bl, bd, n, block_elems, depth, max_dist, vec, s);
  }
}

}  // namespace

// words: (nwords, n) u32 bit patterns; ps, best_len, best_dist: (n,) i32.
// 1 <= nwords <= 8; block_elems is a power of two dividing n;
// 1 <= depth < 128; 0 <= max_dist <= 2^24; prefer_far != 0 takes the
// farther distance on equal length.
extern "C" int compu_lcp_candidates(const void* words, int nwords,
                                    const void* ps, void* best_len,
                                    void* best_dist, long long n,
                                    long long block_elems, int depth,
                                    int max_dist, int prefer_far,
                                    void* stream) {
  auto w = static_cast<const int32_t*>(words);
  auto p = static_cast<const int32_t*>(ps);
  auto bl = static_cast<int32_t*>(best_len);
  auto bd = static_cast<int32_t*>(best_dist);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(w) && aligned16(p) &&
                   aligned16(bl) && aligned16(bd);
  const cudaError_t err =
      prefer_far ? dispatch<true>(w, nwords, p, bl, bd, n, block_elems, depth, max_dist, vec, s)
                 : dispatch<false>(w, nwords, p, bl, bd, n, block_elems, depth, max_dist, vec, s);
  return static_cast<int>(err);
}
