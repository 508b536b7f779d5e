// Back-reference resolution of the device inflates: the expansion (P7) and
// the pointer doubling (P6).
//
// Replaces: no TPU kernel. The reference's jax.lax device loops of its two
// decode paths:
// - P7, the expansion: compu_tpu/kernels/inflate_jax.py
//   _expand_and_resolve (:210), its slot scatter, running max, record
//   gather and source computation (:216-261); and compu_tpu/kernels/
//   inflate_spec.py resolve_foreign's (:184) of its ordered token list
//   (:196-214).
// - P6, the resolution: inflate_jax.py's two while_loops, over the whole
//   map (:291) and, after a compaction, over the unresolved set (:317); and
//   resolve_foreign's while_loop (:231).
// Plain versions: compu_tpu_torch/kernels/inflate_resolve.py
// expand_indexed_torch, expand_foreign_torch, resolve_indexed_torch and
// resolve_foreign_roots_torch.
//
// A root is an int32 a position: -(byte + 1) at a literal (or a stored
// byte), else the position it copies from. Roots are int32 because NT, the
// positions of a call, stays below 2^30 (2^24 on every path): a 16-block
// batch's map is 16 MiB and fits the 50 MB L2.
//
// Bound on the H100. P7: its bytes, the records (or tokens and stored
// bytes) read once and the roots written once. P6: the larger of its bytes
// (the roots read, the bytes written) and its chain: a chain of dependent
// hops, each an L2 load, of ceil(log2(longest chain + 1)) hops, since a
// round of doubling can do no better than square the reach of every
// position.
//
// Design. The indexed expansion and the resolution need grid-wide steps in
// order; each is one cooperative launch (cudaLaunchCooperativeKernel: every
// block resident at once, at most kMaxGrid of them) with grid-wide barriers
// (cooperative_groups' grid.sync()) between its steps; their round counts
// live in device memory (a counter block zeroed by a memset in the same
// stream), so no step waits for the host. The foreign expansion needs no
// barrier and is a plain launch.
//
// P7, indexed (expand_indexed_kernel), over the scan's records (L, R) int32:
// start in the lane's frame (9 bits, 511 none) | is_lit | payload (15
// bits). The plain version scatter-maxes slot ids (row-major (lane, k) + 1)
// at the valid records' flat starts lane * 128 + start and takes a running
// max. The slot ids rise with the lane, so position p (in lane l) takes the
// largest slot among the valid records of lanes <= l whose flat start is
// <= p; only lanes l-3..l can hold a record starting after p (a 9-bit start
// reaches 510 past its lane's base), and every valid record of an earlier
// lane qualifies. One barrier:
//   1. a warp two lanes at a time reads their R records (coalesced) and
//      writes each one's summary, (the largest slot id of a valid record
//      starting in the map) << 1 | (a record starts past the lane's own 128
//      positions), and that record's word; each block the maximum over its
//      contiguous chunk of lanes;
//   2. a warp a lane of positions: the carry is the largest summary of the
//      lanes before it (of those before l-3 where one of l-3..l-1 reaches
//      past its segment), found in the window of the 32 lanes before it,
//      else further back through the lanes of that chunk and then the
//      chunks' maxima (the summaries rise with the lane, so the first
//      window that holds one holds the largest); the lane's own records
//      (and, where they reach, those of the three before it) max their
//      slot ids into 128 cells of shared memory at their starts, a warp
//      scan of the cells with the carry gives each position its slot, and
//      tok = clamp(slot - 1, 0, L * R - 1), the record's fields, start =
//      (tok / R) * 128 + its start, dist = payload + 1, src = start - dist +
//      floormod(pos - start, dist) and the root follow (the fields from the
//      lane's records kept in shared memory, or from the carry's word); each
//      lane writes 4 roots with one 16-byte store. The next lane's records
//      and window are loaded before this one is scanned.
// P7, foreign (expand_foreign_kernel), over the ordered token list (is_lit,
// payload, start; starts rising): each position takes the last token that
// starts at or before it (token 0 for a position before every start). A
// block takes a run of tiles of kForeignTile positions in order; it finds
// the first token starting at or after its first tile by a search with a
// probe a thread (128-way rounds, three or four of them), and each tile's
// tokens follow the last one's. The tile's tokens mark their start offsets
// in shared memory with their index (four a thread a round, until one
// starts past the tile) and keep their fields beside; a block max-scan over
// the marks gives each position its token (the one before the tile where
// none has started); each thread takes 8 positions, their stored bytes and
// mask as one 8-byte load each, and the tile's roots go out through shared
// memory as coalesced 16-byte stores; the next tile's stored bytes and first
// round of tokens are loaded a tile ahead. A token whose range runs over
// stored blocks is no thread's loop: a tile with no start takes the token
// before it. Small tiles and blocks keep many blocks on each SM (on an
// H100, tiles of 1,024 with 128 threads beat 2,048 and 4,096 with 256).
// P6 (resolve_kernel), the reference's schedule to the round, so that its
// `ok` and bytes are the reference's on every input, corrupt ones
// (cycles; chains through positions outside the valid set) included:
//   - whole-map rounds, each the reference's two synchronous hops (y = x o
//     x, then x' = y o y), counting the unresolved valid positions after
//     each, while that count is above ksub and fewer than max_iters rounds
//     have run;
//   - then, if any is left and ksub > 0, the first ksub of them in
//     position order (the compaction), and rounds of one hop over that set
//     while any is unresolved and fewer than max_iters such rounds have
//     run;
//   - out = -root - 1 (as a byte), 0 where unresolved; ok = scan_ok and
//     every valid position resolved; rounds = (whole-map, compacted).
// A round's two hops are x' = x o x o x o x (negatives fixed), so a round is
// one pass: each position follows its root three more hops through the map
// of the round before, and the round writes the other of two maps (X after
// odd rounds, Y after even), one grid barrier a round. The map is cut into
// tiles of kTile positions, a warp a tile, tiles dealt to the warps in
// turn: 16 rows of 32 neighbours, so a row's loads and, along a match, its
// gathers are each one run (16 loads, then each hop's gathers in flight
// together); a warp reads its tiles' states 32 at a time. A resolved root
// (< 0) is a fixpoint of every hop, so a round needs only the tiles that
// still hold an unresolved position (valid or not: chains may run through
// positions past a block's length); a tile's state says which: active;
// resolved in the last map (the other still holds its values of the round
// before, so the next round copies it and writes its bytes); final in both
// maps. Round 1 reads the input itself and runs before the count that
// decides whether it runs (it writes only X, the states and both counts):
// the count before the first round comes from the same pass. Each round
// writes each tile's unresolved valid count and adds it to its chunk's (by
// the round mod 3), so the compaction finds each block's offset in
// position order from the chunks' sums without a pass of its own. The
// compaction writes the set's positions and roots, and over each one a
// marker, -257 - (its index), into the last round's map (literal roots are
// cut to -(byte + 1) when read from the input, so no root is a marker;
// where no round ran, X takes the unfinished tiles' input here); a
// compacted round reads the map at each element's root and, at a marker,
// the element's last value: one barrier a round, no write-back into the
// map. A last pass over the unfinished tiles writes their bytes, the last
// block to finish writes ok and the rounds.
// The indexed resolution passes ns (a position p is valid where
// p % N < ns[p / N]), ksub = max(128, NT / 8) and max_iters =
// ceil(log2 NT); the foreign one no ns (every position valid), ksub 0 and
// max_iters = max(12, ceil(log2 NT)).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;              // threads a block of the cooperative kernels (two an SM)
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 128;                  // output bytes a lane
constexpr int kRecLoads = 6;               // record loads a lane of a warp has in flight
constexpr int kStashR = 32 * kRecLoads;    // records a lane the expansion keeps in shared memory
constexpr int kNoToken = 511;
constexpr int kMaxGrid = 2048;             // blocks a cooperative launch at most
constexpr int kMaxRounds = 64;             // > any max_iters (NT < 2^30)
constexpr int kTile = 512;                 // positions a tile of the resolution (a warp's)
constexpr int kPer = kTile / 32;           // positions a lane of a tile
constexpr int kForeignThreads = 128;       // threads a block of the foreign expansion
constexpr int kForeignTile = 1024;         // positions a tile of it
constexpr int kForeignPer = kForeignTile / kForeignThreads;  // positions a thread
static_assert(kForeignTile <= 4096, "a token's offset in its tile is 12 bits");
static_assert(kForeignPer == 4 || kForeignPer == 8 || kForeignPer == 16,
              "a thread's stored bytes are one load");
constexpr int kForeignTokens = 4;          // tokens a thread loads a round
// The counter block: the unresolved valid count before the first
// whole-map round and after each, the compacted set's size and its
// unresolved count after each of its rounds, the "a valid position is
// unresolved" flag, the blocks done and round 1's count.
constexpr int kCtrSub = kMaxRounds;
constexpr int kCtrBad = 2 * kMaxRounds;
constexpr int kCtrDone = 2 * kMaxRounds + 1;
constexpr int kCtrNext = 2 * kMaxRounds + 2;  // round 1's count, before it is known to run
constexpr int kCtrWords = 2 * kMaxRounds + 4;
constexpr int kMarker = -257;              // X at the compacted set's i-th position: kMarker - i
constexpr int kActive = 0, kXDone = 1, kFinal = 2;   // a tile's state
constexpr unsigned kFull = 0xffffffffu;

// Block-wide exclusive max scan of v >= 0 over kN threads (0 for the
// first). Every thread of the block calls it.
template <int kN>
__device__ __forceinline__ int block_exscan_max(int v, int* warp_tot) {
  constexpr int kW = kN / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = max(inc, u);
  }
  int ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = 0;
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    int t = lane < kW ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = max(t, u);
    }
    if (lane < kW) warp_tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) ex = max(ex, warp_tot[w - 1]);
  __syncthreads();  // warp_tot is free for the next call
  return ex;
}

// Block-wide exclusive sum scan of v >= 0; *total gets the block's sum.
__device__ __forceinline__ int block_scan_sum(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int c = lane < kWarps ? warp_tot[lane] : 0;
    int t = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kWarps) warp_tot[lane] = t - c;  // exclusive
    if (lane == kWarps - 1) warp_tot[kWarps] = t;
  }
  __syncthreads();
  const int ex = warp_tot[w] + inc - v;
  *total = warp_tot[kWarps];
  __syncthreads();
  return ex;
}

// Block-wide reductions over kN threads, the result in every thread.
template <int kN = kThreads>
__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kN / 32 ? red[threadIdx.x & 31] : 0;
  v = __reduce_max_sync(kFull, v);
  __syncthreads();
  return v;
}

template <int kN = kThreads>
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kN / 32 ? red[threadIdx.x & 31] : 0;
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  return v;
}

// A match position's root: its source start - dist + floormod(pos - start,
// dist), clamped into the map.
// floormod(m, dist), out of line: the rare case (a position before its
// token's start, or one a period or more into an overlapping match).
__device__ __noinline__ int floormod(int m, int dist) {
  m %= dist;
  return m < 0 ? m + dist : m;
}

__device__ __forceinline__ int32_t match_root(int pos, int start, int dist, int nt) {
  int m = pos - start;
  if (static_cast<unsigned>(m) >= static_cast<unsigned>(dist)) m = floormod(m, dist);
  return min(max(start - dist + m, 0), nt - 1);
}

// The lane of record slot tok, out of line: the rare case of a record of
// another lane.
__device__ __noinline__ int lane_of(int tok, int r) { return tok / r; }

__device__ __forceinline__ int at(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set(int4& v, int e, int x) {
  if (e == 0) v.x = x; else if (e == 1) v.y = x; else if (e == 2) v.z = x; else v.w = x;
}

// Byte e (0-15) of a 16-byte vector, e known at compile time.
__device__ __forceinline__ int get_byte(const uint4& v, int e) {
  const uint32_t word = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (word >> (8 * (e & 3))) & 0xFF;
}

__device__ __forceinline__ void put_byte(uint4& v, int e, uint32_t b) {
  const uint32_t bits = (b & 0xFF) << (8 * (e & 3));
  if (e < 4) {
    v.x |= bits;
  } else if (e < 8) {
    v.y |= bits;
  } else if (e < 12) {
    v.z |= bits;
  } else {
    v.w |= bits;
  }
}

// kForeignPer bytes from p (aligned to their size) into the low bytes of v.
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint4* v) {
  if (kForeignPer == 16) {
    *v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (kForeignPer == 8) {
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
    *v = make_uint4(h.x, h.y, 0, 0);
  } else {
    *v = make_uint4(__ldg(reinterpret_cast<const unsigned*>(p)), 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// P7, indexed
// ---------------------------------------------------------------------------

// The largest lane summary over lanes [0, j]: windows of 32 lanes back to
// the start of j's chunk, then the chunks' maxima. Summaries rise with the
// lane where not 0, so the first window that holds one holds the largest.
__device__ __forceinline__ int summary_upto(int j, const int32_t* summ, const int32_t* chunk_max,
                                            int chunk) {
  if (j < 0) return 0;
  const int lane = threadIdx.x & 31;
  const int c = j / chunk, lo = c * chunk;
  for (int hi = j; hi >= lo; hi -= 32) {
    const int i = hi - lane;
    const int m = __reduce_max_sync(kFull, i >= lo ? __ldcg(&summ[i]) : 0);
    if (m) return m;
  }
  for (int hi = c - 1; hi >= 0; hi -= 32) {
    const int i = hi - lane;
    const int m = __reduce_max_sync(kFull, i >= 0 ? __ldcg(&chunk_max[i]) : 0);
    if (m) return m;
  }
  return 0;
}

// Max each valid record of lane `src` (r records a lane) that starts at
// or before the end of lane `dst` into cells[its start relative to dst's
// base, at least 0]; kRecLoads loads a lane in flight.
__device__ __forceinline__ void scatter_lane(const int32_t* __restrict__ rec, int r, int src,
                                             int dst, int* cells) {
  const int shift = (dst - src) * kSeg;
  const long long row = static_cast<long long>(src) * r;
  for (int k0 = threadIdx.x & 31; k0 < r; k0 += 32 * kRecLoads) {
    int v[kRecLoads];
#pragma unroll
    for (int u = 0; u < kRecLoads; ++u) {
      const int k = k0 + 32 * u;
      v[u] = k < r ? __ldg(&rec[row + k]) : kNoToken;
    }
#pragma unroll
    for (int u = 0; u < kRecLoads; ++u) {
      const int s = v[u] & 0x1FF;
      const int idx = s - shift;
      if (s < kNoToken && idx < kSeg) {
        atomicMax(&cells[max(idx, 0)], static_cast<int>(row + k0 + 32 * u + 1));
      }
    }
  }
}

// One lane's summary and the record word of its largest valid slot (the
// warp's, in every lane) from records v of its chunk k0 (kRecLoads a lane).
__device__ __forceinline__ void summarise(const int (&v)[kRecLoads], long long row, int k0, int l,
                                          int nt, int* top, int* word, int* reach) {
#pragma unroll
  for (int u = 0; u < kRecLoads; ++u) {
    const int s = v[u] & 0x1FF;
    if (s < kNoToken && static_cast<long long>(l) * kSeg + s < nt) {
      *top = static_cast<int>(row + k0 + 32 * u + 1);
      *word = v[u];
      *reach |= s >= kSeg;
    }
  }
}

// The warp's largest `top` and its word; (top << 1 | any reach).
__device__ __forceinline__ int summary_of(int top, int word, int reach, int* top_word) {
  const int mx = __reduce_max_sync(kFull, top);
  const unsigned who = __ballot_sync(kFull, mx && top == mx);
  *top_word = __shfl_sync(kFull, word, who ? __ffs(who) - 1 : 0);
  return mx << 1 | (__any_sync(kFull, reach) ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads, 2)
expand_indexed_kernel(const int32_t* __restrict__ rec, int nrec, int r, int nt,
                      int32_t* __restrict__ root, int32_t* __restrict__ summ,
                      int32_t* __restrict__ last_word, int32_t* __restrict__ chunk_max) {
  __shared__ int red[kWarps + 1];
  __shared__ __align__(16) int cells[kWarps][kSeg];
  __shared__ int stash[kWarps][kStashR];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nlanes = nrec / r;
  const int chunk = (nlanes + gridDim.x - 1) / gridDim.x;

  // 1. The lane summaries, their last records' words and each block's
  // chunk maximum; two lanes a warp at a time.
  int best = 0;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, nlanes);
  const int hi = min(lo + chunk, nlanes);
  for (int l = lo + w; l < hi; l += 2 * kWarps) {
    const int l2 = l + kWarps;
    const long long row = static_cast<long long>(l) * r;
    const long long row2 = row + static_cast<long long>(kWarps) * r;
    int top = 0, word = 0, reach = 0, top2 = 0, word2 = 0, reach2 = 0;
    for (int k0 = lane; k0 < r; k0 += 32 * kRecLoads) {
      int v[kRecLoads], v2[kRecLoads];
#pragma unroll
      for (int u = 0; u < kRecLoads; ++u) {
        const int k = k0 + 32 * u;
        v[u] = k < r ? __ldg(&rec[row + k]) : kNoToken;
        v2[u] = l2 < hi && k < r ? __ldg(&rec[row2 + k]) : kNoToken;
      }
      summarise(v, row, k0, l, nt, &top, &word, &reach);
      summarise(v2, row2, k0, l2, nt, &top2, &word2, &reach2);
    }
    int tw, tw2;
    const int enc = summary_of(top, word, reach, &tw);
    const int enc2 = summary_of(top2, word2, reach2, &tw2);
    if (lane == 0) {
      summ[l] = enc;
      last_word[l] = tw;
      if (l2 < hi) {
        summ[l2] = enc2;
        last_word[l2] = tw2;
      }
    }
    best = max(best, max(enc, enc2));
  }
  best = block_max(best, red);
  if (threadIdx.x == 0) chunk_max[blockIdx.x] = best;
  grid.sync();

  // 2. A warp a lane of positions; the next lane's records and summaries
  // loaded while this one is written.
  int* mine = cells[w];
  int* kept = stash[w];
  const bool stashed = r <= kStashR;
  const int plane = (nt + kSeg - 1) / kSeg;
  const int nwarps = gridDim.x * kWarps;
  int own[kRecLoads], enc, lw;
  auto fetch = [&](int l, int (&o)[kRecLoads], int* e, int* wd) {
    const long long row = static_cast<long long>(l) * r;
#pragma unroll
    for (int u = 0; u < kRecLoads; ++u) {
      const int k = lane + 32 * u;
      o[u] = stashed && l < nlanes && k < r ? __ldg(&rec[row + k]) : kNoToken;
    }
    // The 32 lanes before l.
    const int i = l - 1 - lane;
    const bool in = i >= 0 && i < nlanes;
    *e = in ? __ldcg(&summ[i]) : 0;
    *wd = in ? __ldcg(&last_word[i]) : 0;
  };
  const int first = blockIdx.x * kWarps + w;
  if (first < plane) fetch(first, own, &enc, &lw);
  for (int l = first; l < plane; l += nwarps) {
    int own_n[kRecLoads], enc_n = 0, lw_n = 0;
    if (l + nwarps < plane) fetch(l + nwarps, own_n, &enc_n, &lw_n);
    const long long row = static_cast<long long>(l) * r;
    // The carry: the largest summary of the 32 lanes before l, unless one
    // of the three nearest reaches past its own segment (then only those
    // before l - 3 carry, and the three scatter their records here); with
    // its record's word where it came from this window.
    const bool reach_in = __ballot_sync(kFull, lane < 3 && (enc & 1)) != 0;
    const int masked = reach_in && lane < 3 ? 0 : enc;
    int carry = __reduce_max_sync(kFull, masked);
    const unsigned who = __ballot_sync(kFull, carry && masked == carry);
    const int carry_word = __shfl_sync(kFull, lw, who ? __ffs(who) - 1 : 0);
    if (!carry) carry = summary_upto(min(l - 33, nlanes - 1), summ, chunk_max, chunk);
    carry >>= 1;
    reinterpret_cast<int4*>(mine)[lane] = make_int4(0, 0, 0, 0);
    __syncwarp();
    if (stashed) {
#pragma unroll
      for (int u = 0; u < kRecLoads; ++u) {
        const int k = lane + 32 * u;
        const int s = own[u] & 0x1FF;
        if (k < r) kept[k] = own[u];
        if (s < kSeg) atomicMax(&mine[s], static_cast<int>(row + k + 1));
      }
    } else if (l < nlanes) {
      scatter_lane(rec, r, l, l, mine);
    }
    if (reach_in) {
      for (int d = 1; d <= 3; ++d) {
        if (l - d >= 0 && l - d < nlanes) scatter_lane(rec, r, l - d, l, mine);
      }
    }
    __syncwarp();
    int4 c = reinterpret_cast<const int4*>(mine)[lane];
    c.y = max(c.y, c.x);
    c.z = max(c.z, c.y);
    c.w = max(c.w, c.z);
    int run = c.w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, run, o);
      if (lane >= o) run = max(run, u);
    }
    int before = __shfl_up_sync(kFull, run, 1);
    before = max(lane ? before : 0, carry);
    const int base = l * kSeg + 4 * lane;
    const int own_lo = l < nlanes ? static_cast<int>(row) : nrec;  // the lane's slots, if any
    int4 out;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = max(at(c, e), before);
      const int tok = min(max(slot - 1, 0), nrec - 1);
      const bool here = tok >= own_lo && tok < own_lo + r;
      const uint32_t v = static_cast<uint32_t>(
          here && stashed             ? kept[tok - own_lo]
          : who && slot == carry      ? carry_word
                                      : __ldg(&rec[tok]));
      const int payload = (v >> 10) & 0x7FFF;
      const int tl = here ? l : lane_of(tok, r);
      set(out, e, (v >> 9) & 1 ? -(payload + 1)
                               : match_root(base + e, tl * kSeg + static_cast<int>(v & 0x1FF),
                                            payload + 1, nt));
    }
    if (base + 3 < nt) {
      *reinterpret_cast<int4*>(&root[base]) = out;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (base + e < nt) root[base + e] = at(out, e);
      }
    }
    __syncwarp();  // the cells and the stash are read before the next lane writes them
#pragma unroll
    for (int u = 0; u < kRecLoads; ++u) own[u] = own_n[u];
    enc = enc_n;
    lw = lw_n;
  }
}

// ---------------------------------------------------------------------------
// P7, foreign
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kForeignThreads)
expand_foreign_kernel(const int32_t* __restrict__ is_lit, const int32_t* __restrict__ payload,
                      const int32_t* __restrict__ starts, int ntok,
                      const uint8_t* __restrict__ stored_out,
                      const bool* __restrict__ stored_mask, int nt, int tiles_per_block,
                      int32_t* __restrict__ root) {
  // Per tile: the marks (a token's index in the tile + 1 at its start
  // offset), then the roots; the tile's tokens' fields, offset | is_lit <<
  // 12 | payload << 13 (slot 0: the token before the tile).
  __shared__ __align__(16) int32_t s_map[kForeignTile];
  __shared__ int32_t s_tok[kForeignTile + 1];
  __shared__ int s_carry_start;
  __shared__ int red[kForeignThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int ntiles = (nt + kForeignTile - 1) / kForeignTile;
  const int t_lo = blockIdx.x * tiles_per_block;
  const int t_hi = min(t_lo + tiles_per_block, ntiles);
  if (t_lo >= t_hi) return;
  const bool vec = ((reinterpret_cast<uintptr_t>(stored_out) |
                     reinterpret_cast<uintptr_t>(stored_mask)) % kForeignPer) == 0;

  // The first token starting at or after the first tile: a probe a thread
  // a round.
  int tnext;
  {
    const int target = t_lo * kForeignTile;
    int lo = 0, hi = ntok;  // the answer lies in [lo, hi]
    while (lo < hi) {
      const int step = (hi - lo + kForeignThreads - 1) / kForeignThreads;
      const int idx = lo + tid * step;
      const int below = __syncthreads_count(idx < hi && __ldg(&starts[idx]) < target);
      if (below == 0) {
        hi = lo;
      } else {
        const int nlo = lo + (below - 1) * step + 1;
        hi = min(hi, lo + below * step);
        lo = nlo;
      }
    }
    tnext = lo;
  }

  // The stored bytes and mask of a tile's 16 positions of this thread, and
  // a round of tokens from `from` (all three fields, kForeignTokens a
  // thread): each loaded a tile ahead.
  auto load_stored = [&](int t, uint4* sb, uint4* sm) {
    const int mine = t * kForeignTile + tid * kForeignPer;
    *sb = make_uint4(0, 0, 0, 0);
    *sm = make_uint4(0, 0, 0, 0);
    if (vec && mine + kForeignPer <= nt) {
      load_bytes(stored_out + mine, sb);
      load_bytes(reinterpret_cast<const uint8_t*>(stored_mask) + mine, sm);
    } else {
#pragma unroll
      for (int e = 0; e < kForeignPer; ++e) {
        if (mine + e < nt) {
          put_byte(*sb, e, stored_out[mine + e]);
          put_byte(*sm, e, stored_mask[mine + e]);
        }
      }
    }
  };
  int pst[kForeignTokens], plit[kForeignTokens], ppay[kForeignTokens];
  auto load_tokens = [&](int from) {
#pragma unroll
    for (int k = 0; k < kForeignTokens; ++k) {
      const int i = from + k * kForeignThreads + tid;
      const bool in = i < ntok;
      pst[k] = in ? __ldg(&starts[i]) : nt;
      plit[k] = in ? __ldg(&is_lit[i]) : 0;
      ppay[k] = in ? __ldg(&payload[i]) : 0;
    }
  };
  uint4 sb, sm;
  load_stored(t_lo, &sb, &sm);
  load_tokens(tnext);

  for (int t = t_lo; t < t_hi; ++t) {
    const int p0 = t * kForeignTile;
    const int mine = p0 + tid * kForeignPer;   // this thread's positions
    uint4 nsb = make_uint4(0, 0, 0, 0), nsm = make_uint4(0, 0, 0, 0);
    if (t + 1 < t_hi) load_stored(t + 1, &nsb, &nsm);
    const int carry = max(tnext - 1, 0);
    if (tid == 0 && ntok > 0) {
      s_carry_start = __ldg(&starts[carry]);
      s_tok[0] = (__ldg(&is_lit[carry]) != 0) << 12 | __ldg(&payload[carry]) << 13;
    }
#pragma unroll
    for (int k = 0; k < kForeignPer / 4; ++k) {
      reinterpret_cast<int4*>(s_map)[tid * (kForeignPer / 4) + k] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    // The tile's tokens, kForeignTokens a thread a round, until one starts
    // past the tile (the starts rise, so those inside are a prefix); the
    // first round was loaded a tile ahead.
    const int p1 = min(p0 + kForeignTile, nt);
    for (int first = tnext;;) {
      if (first != tnext) load_tokens(first);
      int inside = 0;
#pragma unroll
      for (int k = 0; k < kForeignTokens; ++k) {
        const int i = first + k * kForeignThreads + tid;
        const int st = pst[k];
        const int local = i - tnext + 1;
        if (st >= p0 && st < p1 && local <= kForeignTile) {
          s_map[st - p0] = local;
          s_tok[local] = (st - p0) | (plit[k] != 0) << 12 | ppay[k] << 13;
          ++inside;
        }
      }
      const int got = block_sum<kForeignThreads>(inside, red);
      first += got;
      if (got < kForeignTokens * kForeignThreads) {
        tnext = first;
        break;
      }
    }
    if (t + 1 < t_hi) load_tokens(tnext);
    // Each position's token: a running max of the thread's marks, kept in
    // place, then the marks before the thread's (0: the token before the
    // tile); each position's root written over its mark.
    int4* quads = reinterpret_cast<int4*>(s_map) + tid * (kForeignPer / 4);
    int run = 0;
#pragma unroll
    for (int k = 0; k < kForeignPer / 4; ++k) {
      int4 q = quads[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        run = max(run, at(q, e));
        set(q, e, run);
      }
      quads[k] = q;
    }
    const int prev = block_exscan_max<kForeignThreads>(run, red);
    const int carry_start = s_carry_start;
#pragma unroll
    for (int k = 0; k < kForeignPer / 4; ++k) {
      int4 q = quads[k];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * k + e;
        const int local = max(at(q, e), prev);
        int32_t v;
        if (get_byte(sm, i)) {
          v = -(get_byte(sb, i) + 1);
        } else if (ntok == 0) {
          v = 0;
        } else {
          const int f = s_tok[local];
          const int pay = f >> 13;
          const int st = local ? p0 + (f & 0xFFF) : carry_start;
          v = (f >> 12) & 1 ? -(pay + 1) : match_root(mine + i, st, pay + 1, nt);
        }
        set(q, e, v);
      }
      quads[k] = q;
    }
    __syncthreads();
    // Out, coalesced: 16 bytes a thread a row of 1,024 positions.
#pragma unroll
    for (int k = 0; k < kForeignTile / (4 * kForeignThreads); ++k) {
      const int q = k * kForeignThreads + tid;
      const int p = p0 + 4 * q;
      if (p + 3 < nt) {
        *reinterpret_cast<int4*>(&root[p]) = reinterpret_cast<const int4*>(s_map)[q];
      } else {
        for (int e = 0; e < 4 && p + e < nt; ++e) root[p + e] = s_map[4 * q + e];
      }
    }
    __syncthreads();  // s_map, s_tok and the carry are free for the next tile
    sb = nsb;
    sm = nsm;
  }
}

// ---------------------------------------------------------------------------
// P6
// ---------------------------------------------------------------------------

struct ResolveArgs {
  const int32_t* root_in;  // (nt,)
  int nt;
  int n;                   // positions a block (valid: p % n < ns[p / n])
  const int32_t* ns;       // (nt / n,) or null: every position valid
  const bool* scan_ok;     // (1,) or null: true
  int max_iters;
  int ksub;
  int ntiles;              // ceil(nt / kTile)
  int32_t* x;              // (ntiles * kTile,) the map after odd rounds
  int32_t* y;              // (ntiles * kTile,) the map after even rounds
  int32_t* cand;           // (ksub,) the compacted positions
  int32_t* sub0;           // (ksub,) their roots, by the compacted round's parity
  int32_t* sub1;
  int32_t* state;          // (ntiles,) kActive, kXDone, kFinal
  int32_t* vcnt0;          // (ntiles,) unresolved valid positions of a tile in the input
  int32_t* vcnt;           // (ntiles,) ... in the map after the last round
  int32_t* ccnt;           // (3 * kMaxGrid,) of a chunk of tiles, by the round mod 3
  int32_t* ctr;            // (kCtrWords,)
  uint8_t* out;            // (nt,)
  int32_t* ok;             // (1,)
  int32_t* rounds;         // (2,) whole-map, compacted
};

__device__ __forceinline__ bool valid_at(const ResolveArgs& a, int p) {
  const int b = p / a.n;
  return p - b * a.n < __ldg(&a.ns[b]);
}

// Positions base + i of a tile with i < the limit are valid; -1: ask
// valid_at position by position (blocks not a multiple of kTile).
__device__ __forceinline__ int tile_limit(const ResolveArgs& a, int base) {
  if (a.ns == nullptr) return kTile;
  if (a.n % kTile) return -1;
  const int b = base / a.n;
  return __ldg(&a.ns[b]) - (base - b * a.n);
}

__device__ __forceinline__ bool is_valid(const ResolveArgs& a, int lim, int base, int p) {
  return lim >= 0 ? p - base < lim : valid_at(a, p);
}

// A literal root with its byte alone, -(byte + 1) in -256..-1 (the byte
// written is the low 8 bits either way), so that X's markers are no root.
__device__ __forceinline__ int norm(int v) { return v < 0 ? ~(~v & 0xFF) : v; }

// A lane's kPer positions of the tile at `base`: base + 32 j + lane, so
// that each load of a row, and each row of gathers along a match, is one
// run of 32 neighbours.
__device__ __forceinline__ int pos(int base, int j) { return base + 32 * j + (threadIdx.x & 31); }

// The input's values (-1 past nt), their literals normalised.
__device__ __forceinline__ void load_in(const ResolveArgs& a, int base, int (&v)[kPer]) {
  const bool full = base + kTile <= a.nt;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = pos(base, j);
    v[j] = full || p < a.nt ? norm(__ldg(a.root_in + p)) : -1;
  }
}

// A map this launch writes: from the L2.
__device__ __forceinline__ void load_map(const int32_t* m, int base, int (&v)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = __ldcg(m + pos(base, j));
}

__device__ __forceinline__ void store_map(int32_t* m, int base, const int (&v)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) m[pos(base, j)] = v[j];
}

// A round of the lane's roots v (each v = m[p]): the further three hops
// through the map m that the reference's two synchronous hops take
// (y = x o x, then x' = y o y: x' = x o x o x o x, negatives fixed), each
// hop's gathers in flight together. Through the input (kIn), the gathered
// literals normalised.
template <bool kIn>
__device__ __forceinline__ void chase(const int32_t* __restrict__ m, int (&v)[kPer]) {
#pragma unroll
  for (int hop = 0; hop < 3; ++hop) {
    uint32_t un = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) un |= static_cast<uint32_t>(v[j] >= 0) << j;
    if (!__any_sync(kFull, un)) break;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (un >> j & 1) v[j] = kIn ? norm(__ldg(m + v[j])) : __ldcg(m + v[j]);
    }
  }
}

// The tile's unresolved valid positions (the warp's sum, in every lane) and
// whether any position is unresolved.
__device__ __forceinline__ int tile_count(const ResolveArgs& a, int base, const int (&v)[kPer],
                                          bool* any) {
  const int lim = tile_limit(a, base);
  int c = 0, u = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (v[j] >= 0) {
      u = 1;
      c += is_valid(a, lim, base, pos(base, j));
    }
  }
  *any = __any_sync(kFull, u);
  return __reduce_add_sync(kFull, c);
}

// The bytes of the lane's positions of the tile: -root - 1, 0 where
// unresolved.
__device__ __forceinline__ void store_out(const ResolveArgs& a, int base, const int (&v)[kPer]) {
  const bool full = base + kTile <= a.nt;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = pos(base, j);
    if (full || p < a.nt) a.out[p] = static_cast<uint8_t>(v[j] < 0 ? ~v[j] & 0xFF : 0);
  }
}

// Calls f(t, state) for each tile t = gwarp + k * nwarps of this warp,
// the states read 32 tiles at a time, one load a lane.
template <typename F>
__device__ __forceinline__ void for_my_tiles(const ResolveArgs& a, int gwarp, int nwarps, F f) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; gwarp + k0 * nwarps < a.ntiles; k0 += 32) {
    const int tl = gwarp + (k0 + lane) * nwarps;
    const int st = tl < a.ntiles ? __ldcg(&a.state[tl]) : kFinal;
    for (int k = k0; k < k0 + 32 && gwarp + k * nwarps < a.ntiles; ++k) {
      f(gwarp + k * nwarps, __shfl_sync(kFull, st, k - k0));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) resolve_kernel(ResolveArgs a) {
  __shared__ int red[kWarps + 1];
  __shared__ int toff[kThreads];
  __shared__ int tcnt[kThreads];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + w, nwarps = gridDim.x * kWarps;
  const int chunk = (a.ntiles + gridDim.x - 1) / gridDim.x;  // tiles a compaction chunk

  // Round 1 from the input over every tile, before the count that decides
  // whether it runs (it writes X, the states and both counts; a tile
  // resolved in the input is final at once, in both maps and its bytes).
  int cnt0 = 0, cnt1 = 0;
  for (int t = gwarp; t < a.ntiles; t += nwarps) {
    const int base = t * kTile;
    int v[kPer];
    load_in(a, base, v);
    bool any;
    const int c0 = tile_count(a, base, v, &any);
    const bool resolved = !any;
    int c1 = 0;
    if (resolved) {
      store_map(a.x, base, v);
      store_map(a.y, base, v);
      store_out(a, base, v);
    } else {
      chase<true>(a.root_in, v);
      store_map(a.x, base, v);
      c1 = tile_count(a, base, v, &any);
    }
    if (lane == 0) {
      a.state[t] = resolved ? kFinal : any ? kActive : kXDone;
      a.vcnt0[t] = c0;
      a.vcnt[t] = c1;
      if (c0) atomicAdd(&a.ccnt[t / chunk], c0);
      if (c1) atomicAdd(&a.ccnt[kMaxGrid + t / chunk], c1);
      cnt0 += c0;
      cnt1 += c1;
    }
  }
  cnt0 = block_sum(cnt0, red);
  cnt1 = block_sum(cnt1, red);
  if (threadIdx.x == 0 && cnt0) atomicAdd(&a.ctr[0], cnt0);
  if (threadIdx.x == 0 && cnt1) atomicAdd(&a.ctr[kCtrNext], cnt1);
  grid.sync();

  // Whole-map rounds over the unfinished tiles, one pass a round: round r
  // reads the map of round r - 1 (X after odd rounds, Y after even) and
  // writes the other.
  int it = 0;
  int left = __ldcg(&a.ctr[0]);
  if (left > a.ksub && a.max_iters > 0) {
    it = 1;
    left = __ldcg(&a.ctr[kCtrNext]);
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctr[1] = left;
  }
  int cnt = 0;
  while (left > a.ksub && it < a.max_iters) {
    const int r = it + 1;
    const int32_t* src = it & 1 ? a.x : a.y;
    int32_t* dst = it & 1 ? a.y : a.x;
    if (threadIdx.x == 0) a.ccnt[(r + 1) % 3 * kMaxGrid + blockIdx.x] = 0;  // round r + 1's
    int32_t* ccnt = a.ccnt + r % 3 * kMaxGrid;
    cnt = 0;
    for_my_tiles(a, gwarp, nwarps, [&](int t, int st) {
      if (st == kFinal) return;
      const int base = t * kTile;
      int v[kPer];
      load_map(src, base, v);
      if (st == kXDone) {  // resolved a round ago: the other map too from now on
        store_map(dst, base, v);
        store_out(a, base, v);
        if (lane == 0) a.state[t] = kFinal;
        return;
      }
      chase<false>(src, v);
      store_map(dst, base, v);
      bool any;
      const int c = tile_count(a, base, v, &any);
      if (lane == 0) {
        a.vcnt[t] = c;
        if (!any) a.state[t] = kXDone;
        if (c) atomicAdd(&ccnt[t / chunk], c);
        cnt += c;
      }
    });
    cnt = block_sum(cnt, red);
    if (threadIdx.x == 0 && cnt) atomicAdd(&a.ctr[r], cnt);
    grid.sync();
    it = r;
    left = __ldcg(&a.ctr[r]);
  }

  // The compaction: the first ksub unresolved valid positions in position
  // order, block b's chunk of tiles offset by the chunks before it; their
  // positions, roots and markers in the map of the last round (X where no
  // round ran: it takes the unfinished tiles' input here).
  int32_t* map = it & 1 || it == 0 ? a.x : a.y;
  const int32_t* tile_cnt = it ? a.vcnt : a.vcnt0;
  const int nsub = min(left, a.ksub);
  int32_t* cur = a.sub0;
  int32_t* nxt = a.sub1;
  int k = 0;
  if (nsub > 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.ctr[kCtrSub] = nsub;
    const int32_t* ccnt = a.ccnt + it % 3 * kMaxGrid;
    const int lo = min(static_cast<int>(blockIdx.x) * chunk, a.ntiles);
    const int hi = min(lo + chunk, a.ntiles);
    int off = 0;
    for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads) {
      off += __ldcg(&ccnt[b]);
    }
    off = block_sum(off, red);
    for (int t0 = lo; t0 < hi && (it == 0 || off < nsub); t0 += kThreads) {
      const int c = t0 + static_cast<int>(threadIdx.x) < hi ? __ldcg(&tile_cnt[t0 + threadIdx.x]) : 0;
      int total;
      const int ex = block_scan_sum(c, red, &total);
      toff[threadIdx.x] = off + ex;
      tcnt[threadIdx.x] = c;
      __syncthreads();
      for (int i = w; i < min(kThreads, hi - t0); i += kWarps) {
        const int t = t0 + i;
        int o = toff[i];
        if (it > 0 ? tcnt[i] == 0 || o >= nsub : __ldcg(&a.state[t]) == kFinal) continue;
        const int base = t * kTile;
        int v[kPer];
        if (it > 0) {
          load_map(map, base, v);
        } else {
          load_in(a, base, v);
        }
        const int lim = tile_limit(a, base);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int p = pos(base, j);
          const bool f = v[j] >= 0 && is_valid(a, lim, base, p);
          const unsigned bal = __ballot_sync(kFull, f);
          const int q = o + __popc(bal & ((1u << lane) - 1u));
          const bool mark = f && q < nsub;
          if (mark) {
            a.cand[q] = p;
            cur[q] = v[j];
            v[j] = kMarker - q;
          }
          if (it == 0 || mark) map[p] = v[j];
          o += __popc(bal);
        }
      }
      off += total;
      __syncthreads();  // toff and tcnt are free
    }
    grid.sync();

    // Rounds of one hop over the compacted set: an element's root read
    // through the map, and through the element's last value at a marker.
    const int gtid = blockIdx.x * kThreads + threadIdx.x, gsize = gridDim.x * kThreads;
    int lsub = nsub;
    while (lsub > 0 && k < a.max_iters) {
      cnt = 0;
      for (int i = gtid; i < nsub; i += gsize) {
        const int s = __ldcg(&cur[i]);
        int v = s;
        if (s >= 0) {
          v = __ldcg(&map[s]);
          if (v <= kMarker) v = __ldcg(&cur[kMarker - v]);
        }
        nxt[i] = v;
        cnt += v >= 0;
      }
      cnt = block_sum(cnt, red);
      if (threadIdx.x == 0 && cnt) atomicAdd(&a.ctr[kCtrSub + k + 1], cnt);
      grid.sync();
      ++k;
      lsub = __ldcg(&a.ctr[kCtrSub + k]);
      int32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  // The unfinished tiles' bytes, and whether a valid position is left.
  const bool from_input = it == 0 && nsub == 0;
  int bad = 0;
  for_my_tiles(a, gwarp, nwarps, [&](int t, int st) {
    if (st == kFinal) return;
    const int base = t * kTile;
    int v[kPer];
    if (from_input) {
      load_in(a, base, v);
    } else {
      load_map(map, base, v);
    }
    const int lim = tile_limit(a, base);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (v[j] <= kMarker) v[j] = __ldcg(&cur[kMarker - v[j]]);
      bad |= v[j] >= 0 && is_valid(a, lim, base, pos(base, j));
    }
    store_out(a, base, v);
  });
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (bad) atomicOr(&a.ctr[kCtrBad], 1);
    __threadfence();
    if (atomicAdd(&a.ctr[kCtrDone], 1) == static_cast<int>(gridDim.x) - 1) {
      __threadfence();
      const bool scan_ok = a.scan_ok == nullptr || *a.scan_ok;
      a.ok[0] = scan_ok && __ldcg(&a.ctr[kCtrBad]) == 0;
      a.rounds[0] = it;
      a.rounds[1] = k;
    }
  }
}

// Blocks of `kernel` the card holds at once (cached per device), at most
// kMaxGrid; 0 on an error, in *err. A cooperative kernel also needs the
// card to take cooperative launches.
template <typename K>
int resident_blocks(K kernel, int threads, bool coop, int* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, fit = 0, can = 0;
    *err = cudaDeviceGetAttribute(&can, cudaDevAttrCooperativeLaunch, dev);
    if (*err == cudaSuccess && coop && !can) *err = cudaErrorNotSupported;
    if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, 0);
    }
    if (*err != cudaSuccess) return 0;
    if (fit == 0) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    cache[dev] = min(sms * fit, kMaxGrid);
  }
  return cache[dev];
}

int clamp_grid(long long need, int resident) {
  return static_cast<int>(need < 1 ? 1 : need < resident ? need : resident);
}

}  // namespace

// Blocks a cooperative launch may use at most: the size of the per-block
// scratch (the expansion's chunk maxima, the resolution's chunk counts).
extern "C" int compu_inflate_resolve_max_grid() { return kMaxGrid; }

// Words of the resolution's counter block.
extern "C" int compu_inflate_resolve_ctr_words() { return kCtrWords; }

// Positions a tile of the resolution (its maps are ceil(nt / tile) tiles).
extern "C" int compu_inflate_resolve_tile() { return kTile; }

// rec: (nrec,) int32 records, r a row (nrec a multiple of r); root: (nt,)
// int32 out, 16-byte aligned; scratch: (2 nrec / r + kMaxGrid,) int32.
extern "C" int compu_inflate_expand_indexed(const void* rec, long long nrec, int r, long long nt,
                                            void* root, void* scratch, void* stream) {
  if (nt <= 0) return 0;
  if (nrec <= 0 || r <= 0 || nrec % r || nrec >= (1LL << 30) || nt >= (1LL << 30) ||
      reinterpret_cast<uintptr_t>(root) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int cache[64];
  cudaError_t err;
  const int resident = resident_blocks(expand_indexed_kernel, kThreads, true, cache, &err);
  if (!resident) return static_cast<int>(err);
  const long long nlanes = nrec / r, plane = (nt + kSeg - 1) / kSeg;
  const int grid = clamp_grid(((nlanes > plane ? nlanes : plane) + kWarps - 1) / kWarps, resident);
  const int32_t* rec_p = static_cast<const int32_t*>(rec);
  int nrec_i = static_cast<int>(nrec), nt_i = static_cast<int>(nt);
  int32_t* root_p = static_cast<int32_t*>(root);
  int32_t* summ = static_cast<int32_t*>(scratch);
  int32_t* last_word = summ + nlanes;
  int32_t* chunk_max = last_word + nlanes;
  void* args[] = {&rec_p, &nrec_i, &r, &nt_i, &root_p, &summ, &last_word, &chunk_max};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(expand_indexed_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// is_lit, payload, starts: (ntok,) int32, the starts rising, payloads below
// 2^18; stored_out: (nt,) uint8; stored_mask: (nt,) bool; root: (nt,)
// int32 out, 16-byte aligned.
extern "C" int compu_inflate_expand_foreign(const void* is_lit, const void* payload,
                                            const void* starts, long long ntok,
                                            const void* stored_out, const void* stored_mask,
                                            long long nt, void* root, void* stream) {
  if (nt <= 0) return 0;
  if (ntok < 0 || ntok >= (1LL << 30) || nt >= (1LL << 30) ||
      reinterpret_cast<uintptr_t>(root) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int cache[64];
  cudaError_t err;
  const int resident = resident_blocks(expand_foreign_kernel, kForeignThreads, false, cache, &err);
  if (!resident) return static_cast<int>(err);
  const long long ntiles = (nt + kForeignTile - 1) / kForeignTile;
  const int per_block = static_cast<int>((ntiles + resident - 1) / resident);
  const unsigned blocks = static_cast<unsigned>((ntiles + per_block - 1) / per_block);
  expand_foreign_kernel<<<blocks, kForeignThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(is_lit), static_cast<const int32_t*>(payload),
      static_cast<const int32_t*>(starts), static_cast<int>(ntok),
      static_cast<const uint8_t*>(stored_out), static_cast<const bool*>(stored_mask),
      static_cast<int>(nt), per_block, static_cast<int32_t*>(root));
  return static_cast<int>(cudaGetLastError());
}

// root: (nt,) int32 in; ns: (nt / n,) int32 or null;
// scan_ok: (1,) bool or null; scratch: (2 T * tile + 3 ksub + 3 T +
// 3 kMaxGrid + kCtrWords,) int32, T = ceil(nt / tile) (its
// last kCtrWords words the counter block: the unresolved valid count before
// the first whole-map round and after each, then the compacted set's size
// and its count after each of its rounds, by kMaxRounds); out: (nt,) uint8;
// ok: (1,) int32; rounds: (2,) int32.
extern "C" int compu_inflate_resolve(const void* root, long long nt, long long n, const void* ns,
                                     const void* scan_ok, int max_iters, long long ksub,
                                     void* scratch, void* out, void* ok, void* rounds,
                                     void* stream) {
  if (nt <= 0 || nt >= (1LL << 30) || n <= 0 || ksub < 0 || ksub > nt || max_iters < 0 ||
      max_iters >= kMaxRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int cache[64];
  cudaError_t err;
  const int resident = resident_blocks(resolve_kernel, kThreads, true, cache, &err);
  if (!resident) return static_cast<int>(err);
  const long long ntiles = (nt + kTile - 1) / kTile;
  ResolveArgs a;
  int32_t* s = static_cast<int32_t*>(scratch);
  a.root_in = static_cast<const int32_t*>(root);
  a.nt = static_cast<int>(nt);
  a.n = static_cast<int>(n < nt ? n : nt);
  a.ns = static_cast<const int32_t*>(ns);
  a.scan_ok = static_cast<const bool*>(scan_ok);
  a.max_iters = max_iters;
  a.ksub = static_cast<int>(ksub);
  a.ntiles = static_cast<int>(ntiles);
  a.x = s;
  a.y = a.x + ntiles * kTile;
  a.cand = a.y + ntiles * kTile;
  a.sub0 = a.cand + ksub;
  a.sub1 = a.sub0 + ksub;
  a.state = a.sub1 + ksub;
  a.vcnt0 = a.state + ntiles;
  a.vcnt = a.vcnt0 + ntiles;
  a.ccnt = a.vcnt + ntiles;
  a.ctr = a.ccnt + 3 * kMaxGrid;
  a.out = static_cast<uint8_t*>(out);
  a.ok = static_cast<int32_t*>(ok);
  a.rounds = static_cast<int32_t*>(rounds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.ccnt, 0, (3 * kMaxGrid + kCtrWords) * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(resolve_kernel),
                                    dim3(clamp_grid((ntiles + kWarps - 1) / kWarps,
                                                    resident)),
                                    dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
