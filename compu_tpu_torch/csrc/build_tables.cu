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
// Design: one CUDA block of 4 warps a DEFLATE block, one launch a batch,
// with no torch op before it. Warps 0-2 build the lit/len tree together
// (3 symbols a lane, lengths in registers; symbol (warp * 32 + lane) * 3
// + slot, so a lower warp, lane or slot holds a lower index) while warp 3
// stages the code-length start table in shared memory and builds the
// distance tree. Each tree seeds its histogram by ballots
// (seed_histograms' rules: lit/len symbol 0 when fewer than two symbols
// are used; distance symbol 0 when fewer than two are used and it is not,
// then symbol 1 when still fewer than two) and keeps the seeded counts in
// shared memory for the costs.
//
// Start lengths without a logarithm or a division. The plain version's
// p = freq / max(total, 1) is float32's rounded quotient p = fl(f / T),
// and a used symbol starts at 1 + #{k : p < t_k}, where t_k (k = 1..11,
// the device's start_thresholds table) is the least float32 p <= 1 at
// which the plain version's own ops give ceil(-log2 max(p, 2^-30)) <= k.
// The table was computed on this device with those ops over every float32
// of [2^-12, 1] and checked to fall as p rises, so the count is the
// exponent wherever that lies in 1..11. The clamps cannot change it: a
// used symbol has p >= 1 / total > 0, and below 2^-12 the exponent is
// above 11 (the exact -log2 p > 12 and the float ops err by far less than
// 1), so every such p, clamped to 2^-30 or not, lies below every t_k
// (all >= 2^-12 > 2^-30) and counts 11: length 12, the cap clamp's value;
// at the other end the count is 0 (length 1) exactly where the exponent
// is at most 1, the floor clamp's range. Rounding to nearest is monotone,
// so fl(f / T) < t exactly when f / T lies below the midpoint m of t and
// the float before it, or on m when that float's last bit is 0 (the tie
// goes to the even one): the sign of f - m * T, one double fma (m has 25
// bits and T 24, so the product is exact and the sign is right). The
// code-length tree (total 316 or 317) reads its start lengths from
// cl_start_len.
//
// A tree step is one reduction over cached keys, not a pass over the
// alphabet: each lane keeps one key a symbol in registers and picks its
// best of them; a warp reduces its lanes' picks (__reduce_max_sync), and
// the lit/len tree's three warps swap their bests through shared memory
// (one 8-byte word a warp and one named barrier a step, two rows in
// turns).
// - Lengthening (while the Kraft sum is over the budget): the candidate
//   (used, 0 < l < cap) with the most units, lowest index first, else
//   symbol 0. Its units are 2^(cap - l), so the key
//   (cand ? (cap - l + 1) << 9 : 0) | (511 - index) orders exactly as the
//   argmax does, and the largest key gives the symbol and, in every lane,
//   the change of the sum; only its lane picks again.
// - Exact fill (while there is slack): the symbol with the most frequency
//   per unit whose doubling fits. The unit is a power of two, so the score
//   freq_f / 2^(cap - l) is freq_f's float with its exponent lowered:
//   __float_as_uint(freq_f) - ((cap - l) << 23), bit for bit the IEEE
//   quotient for every freq_f >= 1 (no division). Positive floats order as
//   their bits. A warp's winner is its lowest lane with the warp's best key
//   (a ballot), the team's the lowest warp with the best; the winner's
//   units come with its key, every lane updates the slack, the winner's
//   symbol shortens, and every lane picks again at the slack left.
// Why three warps and a full pick, measured with ab_chains.py
// build_tables on drafts of this kernel (PERF.md section 6): with
// the whole lit/len tree in one warp (9 symbols a lane) a fill step took
// 588 cycles, its pick and update over 9 registers a lane being most of
// it, though a warp reduction alone takes 47; three warps (3 a lane) take
// 336, of which the shared-memory swap is about 105 (a chase of the
// four-warp step alone). Keeping each lane's best until it stops fitting
// or its lane wins (the slack only falls, so a symbol that stops fitting
// never fits again), with the winner's next pick made ahead, took 714 in
// one warp and 371 in three: in a warp every lane waits for the winner's
// pick either way, and the extra work lands on the step's chain.
//
// A loop stops at the first step that changes nothing: every later step
// of the reference would change nothing either. The flat-tree fallback
// ranks the team's keys in shared memory. Then every warp sums its share
// of the costs (shuffles) and ranks the lengths of its chunks of 32
// symbols within their length classes (__match_any_sync), whose class
// sizes also make the code-length histogram; warp 0 builds the
// code-length tree, its codes, the header's bits and the block-type
// choice while warps 1-3 make the dynamic canonical codes (a symbol's
// rank in its chunk plus its class's size in the chunks before), and all
// threads write the outputs; the fixed tree's codes are the RFC 1951
// ones, in closed form. Every float operation is an explicit IEEE one
// (__fmul_rn, __fadd_rn, __fma_rn), as the plain version rounds each one.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLit = 286, kDist = 30, kCl = 19;
constexpr int kLens = kLit + kDist;        // 316 lengths, one CL symbol each
constexpr int kHdr = 1 + kCl + kLens;      // 336 header fields
constexpr int kCap = 12, kClCap = 7, kMaxBits = 15;
constexpr int kThresholds = kCap - 1;      // t_1..t_11
constexpr int kFixIters = 16, kFillIters = 64;
constexpr int kLitWarps = 3;               // the lit/len tree's team
constexpr int kLitPerLane = (kLit + 32 * kLitWarps - 1) / (32 * kLitWarps);
constexpr int kClFreqs = kLens + 2;        // the CL start table's columns
constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kLitChunks = (kLit + 31) / 32;
constexpr int kChunks = kLitChunks + 1;    // the lit/len chunks of 32, then the distance one
constexpr int kSizes = 32;                 // class sizes a chunk, by length
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kHdrFirst = 4 | (29 << 3) | (29 << 8) | (15 << 13);

__constant__ int kClOrder[kCl] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                  11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ int fixed_lit_len(int i) {
  return i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
}

// The fixed tree's bit-reversed code of lit/len symbol i (RFC 1951 3.2.6).
__device__ __forceinline__ unsigned fixed_lit_code(int i) {
  const unsigned code = i < 144 ? 0x30 + i : i < 256 ? 0x190 + (i - 144)
                      : i < 280 ? i - 256 : 0xc0 + (i - 280);
  return __brev(code) >> (32 - fixed_lit_len(i));
}

// Kraft units of one symbol: budget >> min(l, cap) for a used symbol of
// length > 0.
__device__ __forceinline__ int units(bool used, int l, int cap) {
  return used && l > 0 ? (1 << cap) >> min(l, cap) : 0;
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The lengthening key of symbol i (see the header).
__device__ __forceinline__ unsigned fix_key(bool used, int l, int i, int cap) {
  const bool cand = used && l > 0 && l < cap;
  return (cand ? static_cast<unsigned>(cap - l + 1) << 9 : 0u) | static_cast<unsigned>(511 - i);
}

// The exact-fill key and units of a symbol whose frequency's float has
// bits fb (0: unused), at length l: 0 and 0 unless it is used and longer
// than 1, else the bits of freq_f / 2^(cap - min(l, cap)) and its units.
__device__ __forceinline__ void fill_key(unsigned fb, int l, int cap, unsigned* key, int* u) {
  const int lc = min(l, cap);
  const bool ok = fb != 0 && l > 1;
  *key = ok ? fb - (static_cast<unsigned>(cap - lc) << 23) : 0u;
  *u = ok ? (1 << cap) >> lc : 0;
}

// The largest of keys[LO, LO + N).
template <int LO, int N, int NPL>
__device__ __forceinline__ unsigned lane_max(const unsigned (&key)[NPL]) {
  if constexpr (N == 1) {
    return key[LO];
  } else {
    return max(lane_max<LO, N / 2>(key), lane_max<LO + N / 2, N - N / 2>(key));
  }
}

struct Pick {
  unsigned key;  // 0: nothing fits
  int slot, u;
};

// The lowest slot of [LO, LO + N) with the largest key among those whose
// units fit the slack.
template <int LO, int N, int NPL>
__device__ __forceinline__ Pick lane_pick(const unsigned (&key)[NPL], const int (&u)[NPL],
                                          int slack) {
  if constexpr (N == 1) {
    const bool fits = u[LO] <= slack;
    return {fits ? key[LO] : 0u, LO, fits ? u[LO] : 0};
  } else {
    const Pick a = lane_pick<LO, N / 2>(key, u, slack);
    const Pick b = lane_pick<LO + N / 2, N - N / 2>(key, u, slack);
    return b.key > a.key ? b : a;
  }
}

// The start thresholds as midpoints (see the header): mid[k] between t_k
// and the float before it, and whether a quotient on mid[k] rounds below
// t_k (that float's last bit is 0).
struct Midpoints {
  double mid[kThresholds];
  bool tie_below[kThresholds];
};

__device__ __forceinline__ Midpoints load_midpoints(const float* __restrict__ thresholds) {
  Midpoints m;
#pragma unroll
  for (int k = 0; k < kThresholds; ++k) {
    const float t = __ldg(thresholds + k);
    const unsigned below = __float_as_uint(t) - 1;
    m.mid[k] = (static_cast<double>(__uint_as_float(below)) + static_cast<double>(t)) * 0.5;
    m.tie_below[k] = (below & 1u) == 0;
  }
  return m;
}

// The warps that build one tree together: one (W = 1), or the lit/len
// tree's three. Symbol (wi * 32 + lane) * NPL + s sits in slot s of lane
// `lane` of the team's warp wi, so lower warps, lanes and slots hold lower
// indices. A team-wide value goes through shared memory: each warp writes
// its word in one of two rows, in turns, then one named barrier (id 1) of
// the team's threads; the turns keep a row from being written again
// before every warp has read it.
template <int W>
struct Team {
  int wi;                  // this warp's index in the team
  unsigned long long* x;   // 2 x 4 words of shared memory (W > 1)
  int turn;

  __device__ __forceinline__ void sync() const {
    if constexpr (W > 1) {
      asm volatile("bar.sync 1, %0;" ::"r"(W * 32) : "memory");
    } else {
      __syncwarp();
    }
  }

  // Each warp's word, from its lane where `writer` holds, in warp order.
  __device__ __forceinline__ void exchange(unsigned long long v, bool writer,
                                           unsigned long long (&all)[W]) {
    if constexpr (W == 1) {
      all[0] = v;
    } else {
      unsigned long long* row = x + 4 * (turn++ & 1);
      if (writer) row[wi] = v;
      sync();
#pragma unroll
      for (int w = 0; w < W; ++w) all[w] = row[w];
    }
  }

  // The team's sum of each warp's total (the same in all its lanes).
  __device__ __forceinline__ long long sum(long long warp_total) {
    unsigned long long all[W];
    exchange(static_cast<unsigned long long>(warp_total), (threadIdx.x & 31) == 0, all);
    long long total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) total += static_cast<long long>(all[w]);
    return total;
  }

  // The team's largest of each warp's largest.
  __device__ __forceinline__ unsigned largest(unsigned warp_max) {
    unsigned long long all[W];
    exchange(warp_max, (threadIdx.x & 31) == 0, all);
    unsigned top = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) top = max(top, static_cast<unsigned>(all[w]));
    return top;
  }
};

// The lit/len or distance tree's start lengths: 1 + #{k : fl(f / T) < t_k}
// for a used symbol, 0 for another.
template <int NPL, int W>
__device__ __forceinline__ void start_lengths(Team<W>& team, const long long (&freq)[NPL],
                                              int (&l)[NPL], const Midpoints& m) {
  long long total = 0;
#pragma unroll
  for (int s = 0; s < NPL; ++s) total += freq[s];
  const double T = __ll2float_rn(max(team.sum(warp_sum64(total)), 1LL));
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const double f = __ll2float_rn(freq[s]);
    int c = 1;
#pragma unroll
    for (int k = 0; k < kThresholds; ++k) {
      const double d = __fma_rn(-m.mid[k], T, f);
      c += d < 0.0 || (d == 0.0 && m.tie_below[k]);
    }
    l[s] = freq[s] > 0 ? c : 0;
  }
}

// build_lengths for one tree on a team: `l` holds the start lengths (0
// for an unused symbol) and returns the code lengths; `s_key` is nsym
// floats of the team's shared memory.
template <int NPL, int W>
__device__ __forceinline__ void build_lengths(Team<W>& team, const long long (&freq)[NPL],
                                              int (&l)[NPL], int nsym, int cap,
                                              const int32_t* __restrict__ k_tab, float* s_key) {
  const int lane = threadIdx.x & 31;
  const int first = (team.wi * 32 + lane) * NPL;  // this lane's first symbol
  const int budget = 1 << cap;
  int sum = 0, nused = 0;
  unsigned key[NPL], fb[NPL];  // fb: the bits of the frequency's float, 0 if unused
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    fb[s] = freq[s] > 0 ? __float_as_uint(__ll2float_rn(freq[s])) : 0u;
    sum += units(fb[s] != 0, l[s], cap);
    nused += fb[s] != 0;
    key[s] = fix_key(fb[s] != 0, l[s], first + s, cap);
  }
  sum = static_cast<int>(team.sum(__reduce_add_sync(kFull, sum)));
  nused = static_cast<int>(team.sum(__reduce_add_sync(kFull, nused)));

  // Lengthening: the best key names the symbol; its units halve.
  unsigned best = lane_max<0, NPL>(key);
  for (int it = 0; it < kFixIters && sum > budget; ++it) {
    const unsigned top = team.largest(__reduce_max_sync(kFull, best));
    const int j = 511 - static_cast<int>(top & 511);
    if (top >= 512) sum -= (budget >> (cap + 1 - static_cast<int>(top >> 9))) >> 1;
    if (j >= first && j < first + NPL) {
#pragma unroll
      for (int s = 0; s < NPL; ++s) {
        if (s == j - first) {
          l[s] += 1;
          key[s] = fix_key(fb[s] != 0, l[s], j, cap);
        }
      }
      best = lane_max<0, NPL>(key);
    }
  }

  // Exact fill: the lowest lane of the lowest warp with the best key
  // gives its units, and its symbol shortens; every lane picks again at
  // the slack left.
  int u[NPL];
#pragma unroll
  for (int s = 0; s < NPL; ++s) fill_key(fb[s], l[s], cap, &key[s], &u[s]);
  Pick mine = lane_pick<0, NPL>(key, u, budget - sum);
  for (int it = 0; it < kFillIters && sum < budget; ++it) {
    const unsigned warp_top = __reduce_max_sync(kFull, mine.key);
    const int winner = __ffs(__ballot_sync(kFull, mine.key == warp_top)) - 1;
    unsigned top;
    int top_units;
    bool won;
    if constexpr (W == 1) {
      top = warp_top;
      if (top == 0) break;  // nothing fits: every later step is the same no-op
      top_units = __shfl_sync(kFull, mine.u, winner);
      won = lane == winner;
    } else {
      unsigned long long all[W];
      team.exchange(static_cast<unsigned long long>(warp_top) << 32 |
                        static_cast<unsigned>(mine.u),
                    lane == winner, all);
      top = static_cast<unsigned>(all[0] >> 32);
      top_units = static_cast<int>(all[0] & 0xffffffffu);
      int at = 0;
#pragma unroll
      for (int w = 1; w < W; ++w) {
        if (static_cast<unsigned>(all[w] >> 32) > top) {
          top = static_cast<unsigned>(all[w] >> 32);
          top_units = static_cast<int>(all[w] & 0xffffffffu);
          at = w;
        }
      }
      if (top == 0) break;
      won = team.wi == at && lane == winner;
    }
    sum += top_units;  // its units double
#pragma unroll
    for (int s = 0; s < NPL; ++s) {
      if (won && s == mine.slot) {
        l[s] -= 1;
        fill_key(fb[s], l[s], cap, &key[s], &u[s]);
      }
    }
    mine = lane_pick<0, NPL>(key, u, budget - sum);
  }
  if (sum == budget) return;

  // The flat complete tree: the used symbols ranked by frequency (stable
  // by index, through the reference's float32 key, rounded twice), the
  // first 2^k - nused of them at depth k - 1, the rest at k.
  const int k = k_tab[nused];
  const int n_short = (1 << k) - nused;
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int i = first + s;
    if (i < nsym) {
      // -fl(freq) is fl(-freq): rounding to nearest is symmetric.
      s_key[i] = __fadd_rn(__fmul_rn(fb[s] != 0 ? -__uint_as_float(fb[s]) : 1.0f,
                                     static_cast<float>(nsym)),
                           static_cast<float>(i));
    }
  }
  team.sync();
#pragma unroll
  for (int s = 0; s < NPL; ++s) {
    const int i = first + s;
    int rank = 0;
    if (fb[s] != 0) {
      const float key_i = s_key[i];
      for (int t = 0; t < nsym; ++t) {
        const float other = s_key[t];
        rank += other < key_i || (other == key_i && t < i);
      }
    }
    l[s] = fb[s] != 0 ? max(rank < n_short ? k - 1 : k, 1) : 0;
  }
  __syncwarp();
}

// canonical_codes, in chunks of 32 symbols, a lane a symbol. A symbol's
// code is its length's first code plus its rank in its length class: the
// class's size in the tree's chunks before its own plus the lanes below it
// in its chunk of the same length (__match_any_sync).

// The rank of this lane's symbol (length len; -1 for no symbol) among the
// chunk's symbols of its length; the chunk's class sizes go to
// size_row[len] for 0 <= len < kSizes (zero beforehand).
__device__ __forceinline__ int chunk_rank(int len, int* size_row) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1;
  const unsigned same = __match_any_sync(kFull, len);
  if ((same & below) == 0 && len >= 0 && len < kSizes) size_row[len] = __popc(same);
  return __popc(same & below);
}

// Lane v's first code of length v (RFC 1951 3.2.2), from lane v's class
// size `size` (0 in lane 0 and above kMaxBits).
__device__ __forceinline__ unsigned first_codes(int size) {
  unsigned code = 0, first = 0;
#pragma unroll
  for (int v = 1; v <= kMaxBits; ++v) {
    code = (code + __shfl_sync(kFull, size, v - 1)) << 1;
    if ((threadIdx.x & 31) == v) first = code;
  }
  return first;
}

// The bit-reversed code of a symbol of length len and rank, from the
// lanes' first codes; 0 for a length outside [1, kMaxBits].
__device__ __forceinline__ uint32_t canonical_code(int len, int rank, unsigned first) {
  const bool coded = len >= 1 && len <= kMaxBits;
  const unsigned f = __shfl_sync(kFull, first, coded ? len : 0);
  return coded ? __brev(f + rank) >> (32 - len) : 0u;
}

__global__ void __launch_bounds__(kThreads)
    build_tables_kernel(const long long* __restrict__ lit_freq,
                        const long long* __restrict__ dist_freq,
                        const long long* __restrict__ extra_l,
                        const long long* __restrict__ extra_d, const long long* __restrict__ ns,
                        const float* __restrict__ thresholds, const int32_t* __restrict__ cl_tab,
                        const int32_t* __restrict__ k_tab, long long* __restrict__ lit_len_out,
                        long long* __restrict__ lit_code_out,
                        long long* __restrict__ dist_len_out,
                        long long* __restrict__ dist_code_out,
                        long long* __restrict__ hdr_vals_out,
                        long long* __restrict__ hdr_bits_out,
                        long long* __restrict__ header_total_out,
                        bool* __restrict__ use_stored_out) {
  __shared__ long long s_freq[kLens];  // the seeded lit/len counts, then the distance ones
  __shared__ int s_len[kLens];  // the dynamic lit/len lengths, then the distance ones
  __shared__ int s_rank[kLens];  // each length's rank in its chunk and class
  __shared__ int s_size[kChunks + 1][kSizes];  // class sizes by chunk; the last row the CL tree's
  __shared__ uint32_t s_code[kLens], s_cl_code[kCl];
  __shared__ int s_cl_len[kCl];
  __shared__ int s_cl_tab[2 * kClFreqs];
  __shared__ float s_key[kLit + 32];  // warp 0's fallback keys, then warp 1's
  __shared__ long long s_cost[kWarps][2];  // each warp's share of the dynamic and fixed costs
  __shared__ unsigned long long s_team[8];  // the lit/len team's exchange rows
  __shared__ bool s_use_dyn;

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long* lf = lit_freq + static_cast<long long>(b) * kLit;
  const long long* df = dist_freq + static_cast<long long>(b) * kDist;

  if (warp < kLitWarps) {
    // The lit/len tree on warps 0-2, 3 symbols a lane.
    Team<kLitWarps> team{warp, s_team, 0};
    const Midpoints mid = load_midpoints(thresholds);
    long long freq[kLitPerLane];
    int l[kLitPerLane], used = 0;
#pragma unroll
    for (int s = 0; s < kLitPerLane; ++s) {
      const int i = tid * kLitPerLane + s;
      freq[s] = i < kLit ? lf[i] : 0;
      used += __popc(__ballot_sync(kFull, freq[s] > 0));
    }
    if (team.sum(used) < 2 && tid == 0) freq[0] += 1;  // EOB's symbol 0 (seed_histograms)
#pragma unroll
    for (int s = 0; s < kLitPerLane; ++s) {
      if (tid * kLitPerLane + s < kLit) s_freq[tid * kLitPerLane + s] = freq[s];
    }
    start_lengths(team, freq, l, mid);
    build_lengths(team, freq, l, kLit, kCap, k_tab, s_key);
#pragma unroll
    for (int s = 0; s < kLitPerLane; ++s) {
      if (tid * kLitPerLane + s < kLit) s_len[tid * kLitPerLane + s] = l[s];
    }
  } else {
    // Warp 3: the code-length start table into shared memory, then the
    // distance tree.
    for (int i = lane; i < 2 * kClFreqs; i += 32) s_cl_tab[i] = cl_tab[i];
    for (int i = lane; i < (kChunks + 1) * kSizes; i += 32) (&s_size[0][0])[i] = 0;
    Team<1> team{0, nullptr, 0};
    const Midpoints mid = load_midpoints(thresholds);
    long long freq[1] = {lane < kDist ? df[lane] : 0};
    const unsigned used = __ballot_sync(kFull, freq[0] > 0);
    if (__popc(used) < 2 && lane == 0 && freq[0] == 0) freq[0] += 1;  // code 0
    if (__popc(__ballot_sync(kFull, freq[0] > 0)) < 2 && lane == 1) freq[0] += 1;  // code 1
    if (lane < kDist) s_freq[kLit + lane] = freq[0];
    int l[1];
    start_lengths(team, freq, l, mid);
    build_lengths(team, freq, l, kDist, kCap, k_tab, s_key + kLit);
    if (lane < kDist) s_len[kLit + lane] = l[0];
  }
  __syncthreads();

  // Each warp's share of the dynamic and fixed body costs, on the seeded
  // counts; and the ranks and class sizes of chunks c = warp, warp + 4,
  // ... (chunk 9: the distance tree), whose sizes also make the
  // code-length histogram.
  {
    long long dyn = 0, fix = 0;
    for (int i = tid; i < kLens; i += kThreads) {
      const long long f = s_freq[i];
      dyn += f * s_len[i];
      fix += f * (i < kLit ? fixed_lit_len(i) : 5);
    }
    dyn = warp_sum64(dyn);
    fix = warp_sum64(fix);
    if (lane == 0) {
      s_cost[warp][0] = dyn;
      s_cost[warp][1] = fix;
    }
    for (int c = warp; c < kChunks; c += kWarps) {
      const int i = c < kLitChunks ? c * 32 + lane : kLit + lane;
      const bool live = c < kLitChunks ? i < kLit : lane < kDist;
      const int rank = chunk_rank(live ? s_len[i] : -1, s_size[c]);
      if (live) s_rank[i] = rank;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // The code-length tree: seeded to two used symbols, its total 316 or
    // 317, its start lengths from the device's table; then its codes, the
    // header's bits (each CL length's count times its code length) and the
    // block-type choice.
    int count = 0;
    if (lane < kCl) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) count += s_size[c][lane];
    }
    long long freq[1] = {count};
    const int seeded = __popc(__ballot_sync(kFull, freq[0] > 0)) < 2;
    if (lane == 1) freq[0] += seeded;
    int l[1] = {freq[0] > 0 ? min(max(s_cl_tab[seeded * kClFreqs + freq[0]], 1), kClCap) : 0};
    Team<1> team{0, nullptr, 0};
    build_lengths(team, freq, l, kCl, kClCap, k_tab, s_key);
    const int len = lane < kCl ? l[0] : -1;
    const int rank = chunk_rank(len, s_size[kChunks]);
    __syncwarp();
    const int size = lane >= 1 && lane <= kMaxBits ? s_size[kChunks][lane] : 0;
    const uint32_t code = canonical_code(len, rank, first_codes(size));
    if (lane < kCl) {
      s_cl_len[lane] = l[0];
      s_cl_code[lane] = code;
    }
    const int hb = __reduce_add_sync(kFull, lane < kCl ? count * l[0] : 0);
    if (lane == 0) {
      long long dyn = 0, fix = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        dyn += s_cost[w][0];
        fix += s_cost[w][1];
      }
      const long long extra = extra_l[b] + extra_d[b];
      const long long dyn_cost = dyn + extra + 14 + kCl * 3 + hb;
      const long long fix_cost = fix + extra;
      const bool use_dyn = dyn_cost < fix_cost;
      const long long n = ns[b];
      s_use_dyn = use_dyn;
      use_stored_out[b] = 8 * (n + 5 * ((n + 65534) / 65535)) < min(dyn_cost, fix_cost);
      header_total_out[b] = use_dyn ? 17 + kCl * 3 + hb : 3;
    }
  } else {
    // The lit/len and distance codes: warp w takes chunks w - 1, w + 2,
    // ..., and warp 1 the distance chunk too.
    int size = 0, dist_size = 0;
    if (lane >= 1 && lane <= kMaxBits) {
#pragma unroll
      for (int c = 0; c < kLitChunks; ++c) size += s_size[c][lane];
      dist_size = s_size[kLitChunks][lane];
    }
    const unsigned first = first_codes(size);
    for (int c = warp - 1; c < kLitChunks; c += kWarps - 1) {
      const int i = c * 32 + lane;
      const int len = i < kLit ? s_len[i] : -1;
      int before = 0;
      for (int d = 0; d < c; ++d) before += len >= 0 ? s_size[d][len] : 0;
      const uint32_t code = canonical_code(len, i < kLit ? s_rank[i] + before : 0, first);
      if (i < kLit) s_code[i] = code;
    }
    if (warp == 1) {
      const int len = lane < kDist ? s_len[kLit + lane] : -1;
      const uint32_t code = canonical_code(len, lane < kDist ? s_rank[kLit + lane] : 0,
                                           first_codes(dist_size));
      if (lane < kDist) s_code[kLit + lane] = code;
    }
  }
  __syncthreads();

  const bool use_dyn = s_use_dyn;
  for (int i = tid; i < kLit; i += kThreads) {
    const int len = use_dyn ? s_len[i] : fixed_lit_len(i);
    lit_len_out[static_cast<long long>(b) * kLit + i] = len;
    lit_code_out[static_cast<long long>(b) * kLit + i] =
        len > 0 ? (use_dyn ? s_code[i] : fixed_lit_code(i)) : 0;
  }
  if (tid < kDist) {
    dist_len_out[b * kDist + tid] = use_dyn ? s_len[kLit + tid] : 5;
    dist_code_out[b * kDist + tid] = use_dyn ? s_code[kLit + tid] : __brev(tid) >> 27;
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

// lit_freq: (nblocks, 286) i64; dist_freq: (nblocks, 30) i64 (the raw
// histograms: the kernel seeds them); extra_l, extra_d, ns: (nblocks,)
// i64; thresholds: (11,) f32; cl_tab: (2, 318) i32; k_tab: (287,) i32.
// Outputs: lit_len, lit_code (nblocks, 286) i64; dist_len, dist_code
// (nblocks, 30) i64; hdr_vals, hdr_bits (nblocks, 336) i64; header_total
// (nblocks,) i64; use_stored (nblocks,) bool.
extern "C" int compu_build_tables(const void* lit_freq, const void* dist_freq,
                                  const void* extra_l, const void* extra_d, const void* ns,
                                  const void* thresholds, const void* cl_tab, const void* k_tab,
                                  void* lit_len, void* lit_code, void* dist_len, void* dist_code,
                                  void* hdr_vals, void* hdr_bits, void* header_total,
                                  void* use_stored, long long nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  using LL = long long;
  build_tables_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LL*>(lit_freq), static_cast<const LL*>(dist_freq),
      static_cast<const LL*>(extra_l), static_cast<const LL*>(extra_d),
      static_cast<const LL*>(ns), static_cast<const float*>(thresholds),
      static_cast<const int32_t*>(cl_tab), static_cast<const int32_t*>(k_tab),
      static_cast<LL*>(lit_len), static_cast<LL*>(lit_code), static_cast<LL*>(dist_len),
      static_cast<LL*>(dist_code), static_cast<LL*>(hdr_vals), static_cast<LL*>(hdr_bits),
      static_cast<LL*>(header_total), static_cast<bool*>(use_stored));
  return static_cast<int>(cudaGetLastError());
}
