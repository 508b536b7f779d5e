// Per-block table stage of the v3 DEFLATE encode (kernel P5): the lit/len
// and distance trees, the code-length tree of the header, the block-type
// choice, the canonical codes and the header fields of every block.
//
// Replaces: no TPU kernel. The reference's _build_tables
// (compu_tpu/kernels/deflate_jax_v3.py:288), run under jax.vmap inside
// the jitted encode (:640): build_lengths' two jax.lax.fori_loops (the
// lengthening steps at :119, the exact-fill steps at :139) and
// canonical_codes' jax.lax.scan (:170). Plain version:
// compu_tpu_torch/kernels/build_tables.py build_tables_torch.
//
// Bound on the H100: the dependent chain. Each tree step (a Kraft-units
// sum and an argmax over the alphabet) needs the step before it, so a
// block takes at least the lit/len tree's steps, then the code-length
// tree's, each a warp-wide reduction; the bytes (about 8 KiB a block) and
// the operations are small beside that chain.
//
// Design: one CUDA block of 4 warps a DEFLATE block. Warp 0 builds the
// lit/len tree (9 symbols a lane, lengths in registers) while warp 1
// builds the distance tree. A step is one pass over a lane's symbols and
// two warp reductions (__reduce_max_sync of the score, then
// __reduce_min_sync of the index among the lanes that hold it: the
// lowest index among equal maxima, as torch.argmax and jnp.argmax take
// it); the Kraft sum is kept exact by adding the changed symbol's unit
// difference, broadcast from its lane. A loop stops at the first step
// that changes nothing: every later step of the reference would change
// nothing either. The flat-tree fallback ranks a warp's keys in shared
// memory. Then all threads count the code-length histogram and the
// costs, warp 0 builds the code-length tree while warps 1-3 make the
// dynamic and the fixed canonical codes (a class rank from
// __match_any_sync a chunk of 32 symbols), and all threads write the
// outputs. Every float operation is an explicit IEEE one (__fdiv_rn,
// __fmul_rn, __fadd_rn): the plain version rounds each one; the start
// lengths come from the wrapper and from tables the device computed with
// the plain version's torch ops, so the kernel takes no logarithm.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLit = 286, kDist = 30, kCl = 19;
constexpr int kLens = kLit + kDist;        // 316 lengths, one CL symbol each
constexpr int kHdr = 1 + kCl + kLens;      // 336 header fields
constexpr int kFixedLit = 288;             // the fixed tree's alphabet
constexpr int kCap = 12, kClCap = 7, kMaxBits = 15;
constexpr int kFixIters = 16, kFillIters = 64;
constexpr int kLitPerLane = (kLit + 31) / 32;
constexpr int kClFreqs = kLens + 2;        // the CL start table's columns
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kHdrFirst = 4 | (29 << 3) | (29 << 8) | (15 << 13);

__constant__ int kClOrder[kCl] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                  11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ int fixed_lit_len(int i) {
  return i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
}

// Kraft units of one symbol: budget >> min(l, cap) for a used symbol of
// length > 0.
__device__ __forceinline__ int units(bool used, int l, int cap) {
  return used && l > 0 ? (1 << cap) >> min(l, cap) : 0;
}

// The lowest index among the lanes' best keys' maximum; each lane's
// (best, at) is its own lowest index of its largest key.
__device__ __forceinline__ int warp_argmax(unsigned best, int at, unsigned* top) {
  *top = __reduce_max_sync(kFull, best);
  return __reduce_min_sync(kFull, best == *top ? at : INT_MAX);
}

// Adds `by` to symbol j's length in the lane that holds it; returns the
// change of the Kraft sum, in every lane.
template <int NPL>
__device__ __forceinline__ int bump(int (&l)[NPL], const bool (&used)[NPL], int j, int by,
                                    int cap) {
  int delta = 0;
  if ((j & 31) == (threadIdx.x & 31)) {
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      if (s == (j >> 5)) {
        const int before = units(used[s], l[s], cap);
        l[s] += by;
        delta = units(used[s], l[s], cap) - before;
      }
    }
  }
  return __shfl_sync(kFull, delta, j & 31);
}

// build_lengths for one tree in one warp: symbol s * 32 + lane in slot s
// of each lane. `l` holds the start lengths (0 for an unused symbol) and
// returns the code lengths; `s_key` is nsym floats of this warp's shared
// memory.
template <int NPL>
__device__ void build_lengths_warp(const long long (&freq)[NPL], int (&l)[NPL], int nsym,
                                   int cap, const int32_t* __restrict__ k_tab, float* s_key) {
  const int lane = threadIdx.x & 31;
  const int budget = 1 << cap;
  bool used[NPL];
  float freq_f[NPL];
  int sum = 0, nused = 0;
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    used[s] = s * 32 + lane < nsym && freq[s] > 0;
    freq_f[s] = __ll2float_rn(freq[s]);
    sum += units(used[s], l[s], cap);
    nused += used[s];
  }
  sum = __reduce_add_sync(kFull, sum);
  nused = __reduce_add_sync(kFull, nused);

  // Lengthening: while the Kraft sum is over the budget, the candidate
  // (used, 0 < l < cap) with the most units, else symbol 0, gets one bit
  // longer. With the sum at or under the budget a step changes nothing.
  for (int it = 0; it < kFixIters && sum > budget; ++it) {
    unsigned best = 0, top;
    int at = lane;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const bool cand = used[s] && l[s] < cap && l[s] > 0;
      const unsigned key = cand ? units(true, l[s], cap) : 0u;  // a score of -1 is key 0
      if (key > best) {
        best = key;
        at = s * 32 + lane;
      }
    }
    sum += bump(l, used, warp_argmax(best, at, &top), 1, cap);
  }

  // Exact fill: while there is slack, the symbol with the most frequency
  // per unit whose doubling fits gets one bit shorter. The scores are
  // positive floats, so their bit patterns order as they do.
  for (int it = 0; it < kFillIters && sum < budget; ++it) {
    const int slack = budget - sum;
    unsigned best = 0, top;
    int at = lane;
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      const int u = units(used[s], l[s], cap);
      const bool fits = used[s] && l[s] > 1 && u <= slack && u > 0;
      const unsigned key = fits ? __float_as_uint(__fdiv_rn(freq_f[s], static_cast<float>(u)))
                                : 0u;
      if (key > best) {
        best = key;
        at = s * 32 + lane;
      }
    }
    const int j = warp_argmax(best, at, &top);
    if (top == 0) break;  // nothing fits: every later step is the same no-op
    sum += bump(l, used, j, -1, cap);
  }
  if (sum == budget) return;

  // The flat complete tree: the used symbols ranked by frequency (stable
  // by index, through the reference's float32 key, rounded twice), the
  // first 2^k - nused of them at depth k - 1, the rest at k.
  const int k = k_tab[nused];
  const int n_short = (1 << k) - nused;
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int i = s * 32 + lane;
    if (i < nsym) {
      s_key[i] = __fadd_rn(__fmul_rn(__ll2float_rn(used[s] ? -freq[s] : 1LL),
                                     static_cast<float>(nsym)),
                           static_cast<float>(i));
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int i = s * 32 + lane;
    int rank = 0;
    if (used[s]) {
      const float key = s_key[i];
      for (int t = 0; t < nsym; ++t) {
        const float other = s_key[t];
        rank += other < key || (other == key && t < i);
      }
    }
    l[s] = used[s] ? max(rank < n_short ? k - 1 : k, 1) : 0;
  }
  __syncwarp();
}

// canonical_codes for one tree in one warp: the bit-reversed canonical
// code of each symbol i < nsym of length len_of(i) into codes[i]; 0 for a
// length outside [1, maxbits]. s_cnt: 32 ints of this warp's shared memory
// (class sizes, then first codes).
template <class Len>
__device__ void canonical_codes_warp(Len len_of, int nsym, int maxbits, uint32_t* codes,
                                     int* s_cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  s_cnt[lane] = 0;
  __syncwarp();
  // Each symbol's rank within its length class, in symbol order.
  for (int base = 0; base < nsym; base += 32) {
    const int i = base + lane;
    const int len = i < nsym ? len_of(i) : 0;
    const bool counted = i < nsym && len >= 1 && len <= maxbits;
    const unsigned same = __match_any_sync(kFull, len);
    if (counted) codes[i] = s_cnt[len] + __popc(same & below);
    __syncwarp();
    if (counted && (same & below) == 0) s_cnt[len] += __popc(same);
    __syncwarp();
  }
  // First code of each length (RFC 1951 3.2.2).
  if (lane >= 1 && lane <= maxbits) {
    unsigned code = 0;
    for (int bits = 1; bits <= lane; ++bits) code = (code + (bits > 1 ? s_cnt[bits - 1] : 0)) << 1;
    s_cnt[16 + lane] = code;
  }
  __syncwarp();
  for (int i = lane; i < nsym; i += 32) {
    const int len = len_of(i);
    codes[i] = len >= 1 && len <= maxbits
                   ? __brev(static_cast<unsigned>(s_cnt[16 + len]) + codes[i]) >> (32 - len)
                   : 0u;
  }
  __syncwarp();
}

__device__ __forceinline__ void block_add(unsigned long long* at, long long v) {
  atomicAdd(at, static_cast<unsigned long long>(v));
}

__global__ void __launch_bounds__(kThreads)
    build_tables_kernel(const long long* __restrict__ lit_freq,
                        const long long* __restrict__ dist_freq,
                        const long long* __restrict__ lit_l0,
                        const long long* __restrict__ dist_l0,
                        const long long* __restrict__ extra_l,
                        const long long* __restrict__ extra_d, const long long* __restrict__ ns,
                        const int32_t* __restrict__ cl_tab, const int32_t* __restrict__ k_tab,
                        long long* __restrict__ lit_len_out, long long* __restrict__ lit_code_out,
                        long long* __restrict__ dist_len_out,
                        long long* __restrict__ dist_code_out,
                        long long* __restrict__ hdr_vals_out,
                        long long* __restrict__ hdr_bits_out,
                        long long* __restrict__ header_total_out,
                        bool* __restrict__ use_stored_out) {
  __shared__ int s_len[kLens];  // the dynamic lit/len lengths, then the distance ones
  __shared__ uint32_t s_lit_code[kLit], s_dist_code[kDist];
  __shared__ uint32_t s_fix_lit_code[kFixedLit], s_fix_dist_code[kDist];
  __shared__ uint32_t s_cl_code[kCl];
  __shared__ int s_cl_len[kCl], s_cl_freq[kCl];
  __shared__ float s_key[kLit + 32];  // warp 0's fallback keys, then warp 1's
  __shared__ int s_cnt[4][32];
  __shared__ unsigned long long s_dyn, s_fix, s_hb;
  __shared__ bool s_use_dyn;

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long* lf = lit_freq + static_cast<long long>(b) * kLit;
  const long long* df = dist_freq + static_cast<long long>(b) * kDist;

  if (tid < kCl) s_cl_freq[tid] = 0;
  if (tid == 0) s_dyn = s_fix = s_hb = 0;
  if (warp == 0) {
    long long freq[kLitPerLane];
    int l[kLitPerLane];
#pragma unroll
    for (int s = 0; s < kLitPerLane; ++s) {
      const int i = s * 32 + lane;
      freq[s] = i < kLit ? lf[i] : 0;
      l[s] = i < kLit ? static_cast<int>(lit_l0[static_cast<long long>(b) * kLit + i]) : 0;
    }
    build_lengths_warp(freq, l, kLit, kCap, k_tab, s_key);
#pragma unroll
    for (int s = 0; s < kLitPerLane; ++s) {
      if (s * 32 + lane < kLit) s_len[s * 32 + lane] = l[s];
    }
  } else if (warp == 1) {
    long long freq[1] = {lane < kDist ? df[lane] : 0};
    int l[1] = {lane < kDist ? static_cast<int>(dist_l0[static_cast<long long>(b) * kDist + lane])
                             : 0};
    build_lengths_warp(freq, l, kDist, kCap, k_tab, s_key + kLit);
    if (lane < kDist) s_len[kLit + lane] = l[0];
  }
  __syncthreads();

  // The code-length histogram and the dynamic and fixed body costs.
  long long dyn = 0, fix = 0;
  for (int i = tid; i < kLens; i += kThreads) {
    const int len = s_len[i];
    const long long f = i < kLit ? lf[i] : df[i - kLit];
    dyn += f * len;
    fix += f * (i < kLit ? fixed_lit_len(i) : 5);
    if (len < kCl) atomicAdd(&s_cl_freq[len], 1);
  }
  block_add(&s_dyn, dyn);
  block_add(&s_fix, fix);
  __syncthreads();

  if (warp == 0) {
    // The code-length tree: seeded to two used symbols, its total 316 or
    // 317, its start lengths from the device's table.
    long long freq[1] = {lane < kCl ? s_cl_freq[lane] : 0};
    const int seeded = __popc(__ballot_sync(kFull, freq[0] > 0)) < 2;
    if (lane == 1) freq[0] += seeded;
    int l[1] = {freq[0] > 0 ? min(max(cl_tab[seeded * kClFreqs + freq[0]], 1), kClCap) : 0};
    build_lengths_warp(freq, l, kCl, kClCap, k_tab, s_key);
    if (lane < kCl) s_cl_len[lane] = l[0];
    __syncwarp();
    canonical_codes_warp([&](int i) { return s_cl_len[i]; }, kCl, kClCap, s_cl_code, s_cnt[0]);
  } else if (warp == 1) {
    canonical_codes_warp([&](int i) { return s_len[i]; }, kLit, kMaxBits, s_lit_code, s_cnt[1]);
  } else if (warp == 2) {
    canonical_codes_warp([&](int i) { return s_len[kLit + i]; }, kDist, kMaxBits, s_dist_code,
                         s_cnt[2]);
  } else {
    canonical_codes_warp([](int i) { return fixed_lit_len(i); }, kFixedLit, kMaxBits,
                         s_fix_lit_code, s_cnt[3]);
    canonical_codes_warp([](int) { return 5; }, kDist, kMaxBits, s_fix_dist_code, s_cnt[3]);
  }
  __syncthreads();

  long long hb = 0;
  for (int i = tid; i < kLens; i += kThreads) hb += s_cl_len[s_len[i]];
  block_add(&s_hb, hb);
  __syncthreads();
  if (tid == 0) {
    const long long dyn_cost = static_cast<long long>(s_dyn) + extra_l[b] + extra_d[b] + 14 +
                               kCl * 3 + static_cast<long long>(s_hb);
    const long long fix_cost = static_cast<long long>(s_fix) + extra_l[b] + extra_d[b];
    const bool use_dyn = dyn_cost < fix_cost;
    const long long n = ns[b];
    s_use_dyn = use_dyn;
    use_stored_out[b] = 8 * (n + 5 * ((n + 65534) / 65535)) < min(dyn_cost, fix_cost);
    header_total_out[b] = use_dyn ? 17 + kCl * 3 + static_cast<long long>(s_hb) : 3;
  }
  __syncthreads();

  const bool use_dyn = s_use_dyn;
  for (int i = tid; i < kLit; i += kThreads) {
    const int len = use_dyn ? s_len[i] : fixed_lit_len(i);
    lit_len_out[static_cast<long long>(b) * kLit + i] = len;
    lit_code_out[static_cast<long long>(b) * kLit + i] =
        len > 0 ? (use_dyn ? s_lit_code[i] : s_fix_lit_code[i]) : 0;
  }
  if (tid < kDist) {
    dist_len_out[b * kDist + tid] = use_dyn ? s_len[kLit + tid] : 5;
    dist_code_out[b * kDist + tid] = use_dyn ? s_dist_code[tid] : s_fix_dist_code[tid];
  }
  for (int i = tid; i < kHdr; i += kThreads) {
    long long val = 0, bits = 0;
    if (!use_dyn) {
      val = i == 0 ? 2 : 0;
      bits = i == 0 ? 3 : 0;
    } else if (i == 0) {
      val = kHdrFirst;
      bits = 17;
    } else if (i <= kCl) {
      val = s_cl_len[kClOrder[i - 1]];
      bits = 3;
    } else {
      const int len = s_len[i - 1 - kCl];
      val = s_cl_code[len];
      bits = s_cl_len[len];
    }
    hdr_vals_out[static_cast<long long>(b) * kHdr + i] = val;
    hdr_bits_out[static_cast<long long>(b) * kHdr + i] = bits;
  }
}

}  // namespace

// lit_freq, lit_l0: (nblocks, 286) i64; dist_freq, dist_l0: (nblocks, 30)
// i64 (seeded histograms and start lengths); extra_l, extra_d, ns:
// (nblocks,) i64; cl_tab: (2, 318) i32; k_tab: (287,) i32. Outputs:
// lit_len, lit_code (nblocks, 286) i64; dist_len, dist_code (nblocks, 30)
// i64; hdr_vals, hdr_bits (nblocks, 336) i64; header_total (nblocks,)
// i64; use_stored (nblocks,) bool.
extern "C" int compu_build_tables(const void* lit_freq, const void* dist_freq, const void* lit_l0,
                                  const void* dist_l0, const void* extra_l, const void* extra_d,
                                  const void* ns, const void* cl_tab, const void* k_tab,
                                  void* lit_len, void* lit_code, void* dist_len, void* dist_code,
                                  void* hdr_vals, void* hdr_bits, void* header_total,
                                  void* use_stored, long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  using LL = long long;
  build_tables_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LL*>(lit_freq), static_cast<const LL*>(dist_freq),
      static_cast<const LL*>(lit_l0), static_cast<const LL*>(dist_l0),
      static_cast<const LL*>(extra_l), static_cast<const LL*>(extra_d),
      static_cast<const LL*>(ns), static_cast<const int32_t*>(cl_tab),
      static_cast<const int32_t*>(k_tab), static_cast<LL*>(lit_len), static_cast<LL*>(lit_code),
      static_cast<LL*>(dist_len), static_cast<LL*>(dist_code), static_cast<LL*>(hdr_vals),
      static_cast<LL*>(hdr_bits), static_cast<LL*>(header_total), static_cast<bool*>(use_stored));
  return static_cast<int>(cudaGetLastError());
}
