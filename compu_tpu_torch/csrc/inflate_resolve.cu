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
// Bound on the H100. P7: its bytes, the records read once and the roots
// written once. P6: the larger of its bytes (the roots read, the bytes
// written) and its chain: a chain of dependent hops, each an L2 load, of
// ceil(log2(longest chain + 1)) hops, since a round of doubling can do no
// better than square the reach of every position.
//
// Design. Both functions need grid-wide steps in order: a scatter before a
// scan, and rounds of hops each of which reads the whole map the last one
// wrote. Each indexed entry and the resolution is one cooperative launch
// (cudaLaunchCooperativeKernel: every block resident at once, at most
// kMaxGrid of them) with grid-wide barriers (cooperative_groups'
// grid.sync()) between its steps; their round counts and "any left" flags
// live in device memory (a counter block zeroed by a memset in the same
// stream), so no step waits for the host. The foreign expansion needs no
// barrier and is a plain launch.
//
// P7, indexed (expand_indexed_kernel), over the scan's records (L, R)
// int32: start in the lane's frame (9 bits, 511 none) | is_lit | payload
// (15 bits):
//   1. zero the map;
//   2. every valid record k (row-major, lane k / R) atomicMax-es its slot id
//      k + 1 at its flat start lane * 128 + start, if that lies in the map
//      (the plain version's scatter_reduce(amax): starts that collide, as
//      corrupt records' can, keep the largest slot id);
//   3. each block takes its maximum over its own contiguous chunk of the
//      map;
//   4. each block carries in the maximum of the chunks before its own and
//      scans its chunk in tiles of kThreads positions (a warp-shuffle scan,
//      then the warps' maxima), which gives each position its slot; then
//      tok = clamp(slot - 1, 0, L * R - 1), the record's fields,
//      start = (tok / R) * 128 + its start, dist = payload + 1,
//      src = start - dist + floormod(pos - start, dist), and the root,
//      written over the slot in place.
// P7, foreign (expand_foreign_kernel), over the ordered token list (is_lit,
// payload, start; starts rising): each position takes the last token that
// starts at or before it (token 0 for a position before every start), the
// running max of the reference and no more. A warp takes 1,024 positions
// at a time, finds the token of the first by a binary search over the
// starts, and then writes a row of 32 positions at a time, coalesced: each
// lane steps from the row's first token to its own (a token covers at
// least one position, so at most 32 steps, mostly none or one). The work is
// the positions', not the tokens': a token whose range runs over stored
// blocks (a stream's incompressible stretch can be many stored blocks in a
// row) is no one warp's loop. A stored position's root is its byte's,
// -(byte + 1).
// P6 (resolve_kernel), the reference's schedule to the round, so that its
// `ok` and bytes are the reference's on every input, corrupt ones
// (cycles; chains through positions outside the valid set) included:
//   - the map is copied into a scratch buffer X (the input stays intact),
//     counting the unresolved valid positions;
//   - whole-map rounds, each two synchronous hops X -> Y -> X (every hop
//     reads only the map the last hop wrote), counting the unresolved
//     valid positions after each, while that count is above ksub and
//     fewer than max_iters rounds have run;
//   - then, if any is left and ksub > 0, the compaction: each block counts
//     its chunk's unresolved valid positions, offsets them by the counts of
//     the blocks before it and writes the first ksub of them, in position
//     order, with their roots (an exclusive block scan a tile);
//   - then rounds of one hop over that set: each element reads the map at
//     its root, a barrier, then writes its new root back into the map, and
//     a flag says whether any is still unresolved; while one is, and fewer
//     than max_iters such rounds have run;
//   - out = -root - 1 (as a byte), 0 where unresolved; ok = scan_ok and
//     every valid position resolved; rounds = (whole-map, compacted).
// The indexed resolution passes ns (a position p is valid where
// p % N < ns[p / N]), ksub = max(128, NT / 8) and max_iters =
// ceil(log2 NT); the foreign one no ns (every position valid), ksub 0 and
// max_iters = max(12, ceil(log2 NT)).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;              // threads a block of the cooperative kernels
constexpr int kWarps = kThreads / 32;
constexpr int kForeignThreads = 256;       // threads a block of the foreign expansion
constexpr int kForeignChunk = 1024;        // positions a warp of it takes at a time
constexpr int kSeg = 128;                  // output bytes a lane
constexpr int kNoToken = 511;
constexpr int kMaxGrid = 2048;             // blocks a cooperative launch at most
constexpr int kMaxRounds = 64;             // > any max_iters (NT < 2^30)
// The counter block: the unresolved count after each whole-map round
// (entry 0 before the first), each compacted round's "any left" flag, and
// the "a valid position is unresolved" flag.
constexpr int kCtrAny = kMaxRounds;
constexpr int kCtrBad = 2 * kMaxRounds;
constexpr int kCtrWords = 2 * kMaxRounds + 4;
constexpr unsigned kFull = 0xffffffffu;

// A counter another block wrote before the last grid barrier: read from L2.
__device__ __forceinline__ int ld_ctr(const int* p) { return __ldcg(p); }

// Block-wide inclusive max scan of v; *total gets the block's maximum.
// Every thread of the block calls it.
__device__ __forceinline__ int block_scan_max(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    int t = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t = max(t, u);
    }
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = max(v, warp_tot[w - 1]);
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is free for the next call
  return v;
}

// Block-wide exclusive sum scan of f (0 or 1); *total gets the block's sum.
__device__ __forceinline__ int block_scan_sum(int f, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned bits = __ballot_sync(kFull, f);
  const int in_warp = __popc(bits & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[w] = __popc(bits);
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
  const int ex = warp_tot[w] + in_warp;
  *total = warp_tot[kWarps];
  __syncthreads();
  return ex;
}

// Block-wide reductions, the result in every thread.
__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kWarps ? red[threadIdx.x & 31] : 0;
  v = __reduce_max_sync(kFull, v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kWarps ? red[threadIdx.x & 31] : 0;
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  return v;
}

// A match position's root: its source start - dist + floormod(pos - start,
// dist), clamped into the map.
__device__ __forceinline__ int32_t match_root(int pos, int start, int dist, int nt) {
  int m = (pos - start) % dist;
  if (m < 0) m += dist;
  return min(max(start - dist + m, 0), nt - 1);
}

// The positions [lo, hi) of block b's contiguous chunk of the map.
__device__ __forceinline__ void chunk_of(int nt, int* lo, int* hi) {
  int chunk = (nt + gridDim.x - 1) / gridDim.x;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  const long long l = static_cast<long long>(blockIdx.x) * chunk;
  *lo = static_cast<int>(min(l, static_cast<long long>(nt)));
  *hi = static_cast<int>(min(l + chunk, static_cast<long long>(nt)));
}

__global__ void __launch_bounds__(kThreads)
expand_indexed_kernel(const int32_t* __restrict__ rec, int nrec, int r, int nt,
                      int32_t* __restrict__ root, int32_t* __restrict__ chunk_max) {
  __shared__ int red[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gsize = gridDim.x * kThreads;
  for (int p = gtid; p < nt; p += gsize) root[p] = 0;
  grid.sync();
  for (int k = gtid; k < nrec; k += gsize) {
    const int s = static_cast<uint32_t>(rec[k]) & 0x1FF;
    if (s < kNoToken) {
      const long long flat = static_cast<long long>(k / r) * kSeg + s;
      if (flat < nt) atomicMax(&root[flat], k + 1);
    }
  }
  grid.sync();
  int lo, hi;
  chunk_of(nt, &lo, &hi);
  int m = 0;
  for (int p = lo + threadIdx.x; p < hi; p += kThreads) m = max(m, root[p]);
  m = block_max(m, red);
  if (threadIdx.x == 0) chunk_max[blockIdx.x] = m;
  grid.sync();
  int carry = 0;
  for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads) {
    carry = max(carry, __ldcg(&chunk_max[b]));
  }
  carry = block_max(carry, red);
  for (int base = lo; base < hi; base += kThreads) {
    const int p = base + threadIdx.x;
    int tile_max;
    const int slot = max(block_scan_max(p < hi ? root[p] : 0, red, &tile_max), carry);
    carry = max(carry, tile_max);
    if (p >= hi) continue;
    const int tok = min(max(slot - 1, 0), nrec - 1);
    const uint32_t v = static_cast<uint32_t>(__ldg(&rec[tok]));
    const int payload = (v >> 10) & 0x7FFF;
    if ((v >> 9) & 1) {
      root[p] = -(payload + 1);
    } else {
      root[p] = match_root(p, (tok / r) * kSeg + static_cast<int>(v & 0x1FF), payload + 1, nt);
    }
  }
}

__global__ void __launch_bounds__(kForeignThreads)
expand_foreign_kernel(const int32_t* __restrict__ is_lit, const int32_t* __restrict__ payload,
                      const int32_t* __restrict__ starts, int ntok,
                      const uint8_t* __restrict__ stored_out,
                      const bool* __restrict__ stored_mask, int nt,
                      int32_t* __restrict__ root) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kForeignThreads + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * kForeignThreads) >> 5;
  for (long long base = static_cast<long long>(warp) * kForeignChunk; base < nt;
       base += static_cast<long long>(nwarps) * kForeignChunk) {
    // The last token that starts at or before the chunk (token 0 if none).
    int lo = 0, hi = ntok;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(&starts[mid]) <= base) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int t = max(lo - 1, 0);
    const int end = static_cast<int>(min(base + kForeignChunk, static_cast<long long>(nt)));
    for (int p0 = static_cast<int>(base); p0 < end; p0 += 32) {
      const int p = p0 + lane;
      int tl = t;
      if (p < end) {
        while (tl + 1 < ntok && __ldg(&starts[tl + 1]) <= p) ++tl;
        int32_t v;
        if (stored_mask[p]) {
          v = -(static_cast<int>(stored_out[p]) + 1);
        } else if (ntok == 0) {
          v = 0;
        } else if (__ldg(&is_lit[tl]) != 0) {
          v = -(__ldg(&payload[tl]) + 1);
        } else {
          v = match_root(p, __ldg(&starts[tl]), __ldg(&payload[tl]) + 1, nt);
        }
        root[p] = v;
      }
      t = __reduce_max_sync(kFull, tl);  // the row's last position's token
    }
  }
}

struct ResolveArgs {
  const int32_t* root_in;  // (nt,)
  int nt;
  int n;                   // positions a block (valid: p % n < ns[p / n])
  const int32_t* ns;       // (nt / n,) or null: every position valid
  const bool* scan_ok;     // (1,) or null: true
  int max_iters;
  int ksub;
  int32_t* x;              // (nt,) the map
  int32_t* y;              // (nt,) the map between a round's two hops
  int32_t* cand;           // (ksub,) the compacted positions
  int32_t* sub;            // (ksub,) their roots
  int32_t* bcnt;           // (kMaxGrid,) per block
  int32_t* ctr;            // (kCtrWords,) zeroed
  uint8_t* out;            // (nt,)
  int32_t* ok;             // (1,)
  int32_t* rounds;         // (2,) whole-map, compacted
};

__device__ __forceinline__ bool valid_at(const ResolveArgs& a, int p) {
  if (a.ns == nullptr) return true;
  const int b = p / a.n;
  return p - b * a.n < __ldg(&a.ns[b]);
}

__global__ void __launch_bounds__(kThreads) resolve_kernel(ResolveArgs a) {
  __shared__ int red[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int gsize = gridDim.x * kThreads;
  int32_t* __restrict__ x = a.x;
  int32_t* __restrict__ y = a.y;

  int cnt = 0;
  for (int p = gtid; p < a.nt; p += gsize) {
    const int v = a.root_in[p];
    x[p] = v;
    cnt += v >= 0 && valid_at(a, p);
  }
  cnt = block_sum(cnt, red);
  if (threadIdx.x == 0 && cnt) atomicAdd(&a.ctr[0], cnt);
  grid.sync();

  // Whole-map rounds: two synchronous hops each.
  int it = 0;
  int left = ld_ctr(&a.ctr[0]);
  while (left > a.ksub && it < a.max_iters) {
    for (int p = gtid; p < a.nt; p += gsize) {
      const int v = x[p];
      y[p] = v >= 0 ? x[v] : v;
    }
    grid.sync();
    cnt = 0;
    for (int p = gtid; p < a.nt; p += gsize) {
      int v = y[p];
      if (v >= 0) v = y[v];
      x[p] = v;
      cnt += v >= 0 && valid_at(a, p);
    }
    cnt = block_sum(cnt, red);
    if (threadIdx.x == 0 && cnt) atomicAdd(&a.ctr[it + 1], cnt);
    grid.sync();
    ++it;
    left = ld_ctr(&a.ctr[it]);
  }

  // The compaction, then rounds of one hop over the compacted set.
  const int nsub = min(left, a.ksub);
  int sub_it = 0;
  if (nsub > 0) {
    int lo, hi;
    chunk_of(a.nt, &lo, &hi);
    cnt = 0;
    for (int p = lo + threadIdx.x; p < hi; p += kThreads) cnt += x[p] >= 0 && valid_at(a, p);
    cnt = block_sum(cnt, red);
    if (threadIdx.x == 0) a.bcnt[blockIdx.x] = cnt;
    grid.sync();
    int off = 0;
    for (int b = threadIdx.x; b < static_cast<int>(blockIdx.x); b += kThreads) {
      off += __ldcg(&a.bcnt[b]);
    }
    off = block_sum(off, red);
    for (int base = lo; base < hi && off < nsub; base += kThreads) {
      const int p = base + threadIdx.x;
      const int v = p < hi ? x[p] : -1;
      const int f = v >= 0 && valid_at(a, p);
      int tile;
      const int at = off + block_scan_sum(f, red, &tile);
      if (f && at < nsub) {
        a.cand[at] = p;
        a.sub[at] = v;
      }
      off += tile;
    }
    grid.sync();
    // Element i belongs to one thread in every round, so sub[i] needs no
    // barrier of its own; the map's reads and writes are a barrier apart.
    bool any = true;
    while (any && sub_it < a.max_iters) {
      for (int i = gtid; i < nsub; i += gsize) {
        const int s = a.sub[i];
        if (s >= 0) a.sub[i] = x[s];
      }
      grid.sync();
      int more = 0;
      for (int i = gtid; i < nsub; i += gsize) {
        const int s = a.sub[i];
        x[a.cand[i]] = s;
        more |= s >= 0;
      }
      more = __syncthreads_or(more);
      if (threadIdx.x == 0 && more) a.ctr[kCtrAny + sub_it] = 1;
      grid.sync();
      any = ld_ctr(&a.ctr[kCtrAny + sub_it]) != 0;
      ++sub_it;
    }
  }

  int bad = 0;
  for (int p = gtid; p < a.nt; p += gsize) {
    const int v = x[p];
    a.out[p] = v < 0 ? static_cast<uint8_t>(-v - 1) : 0;
    bad |= v >= 0 && valid_at(a, p);
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0 && bad) a.ctr[kCtrBad] = 1;
  grid.sync();
  if (gtid == 0) {
    const bool scan_ok = a.scan_ok == nullptr || *a.scan_ok;
    a.ok[0] = scan_ok && ld_ctr(&a.ctr[kCtrBad]) == 0;
    a.rounds[0] = it;
    a.rounds[1] = sub_it;
  }
}

// Blocks of `kernel` the card holds at once (cached per device), at most
// kMaxGrid; 0 on an error, in *err.
template <typename K>
int resident_blocks(K kernel, int threads, int* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    int sms = 0, fit = 0, coop = 0;
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (*err == cudaSuccess && !coop) *err = cudaErrorNotSupported;
    if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess) {
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, 0);
    }
    if (*err != cudaSuccess) return 0;
    cache[dev] = min(sms * fit, kMaxGrid);
  }
  return cache[dev];
}

int grid_for(long long work, int resident) {
  const long long need = (work + kThreads - 1) / kThreads;
  return static_cast<int>(need < 1 ? 1 : need < resident ? need : resident);
}

}  // namespace

// Blocks a cooperative launch may use at most: the size of the per-block
// scratch (chunk_max, the resolution's block counts).
extern "C" int compu_inflate_resolve_max_grid() { return kMaxGrid; }

// Words of the resolution's counter block.
extern "C" int compu_inflate_resolve_ctr_words() { return kCtrWords; }

// rec: (nrec,) int32 records, r a row; root: (nt,) int32 out; chunk_max:
// (kMaxGrid,) int32 scratch.
extern "C" int compu_inflate_expand_indexed(const void* rec, long long nrec, int r, long long nt,
                                            void* root, void* chunk_max, void* stream) {
  if (nt <= 0) return 0;
  if (nrec <= 0 || r <= 0 || nrec >= (1LL << 31) - 1 || nt >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int cache[64];
  cudaError_t err;
  const int resident = resident_blocks(expand_indexed_kernel, kThreads, cache, &err);
  if (!resident) return static_cast<int>(err);
  const int grid = grid_for(nt > nrec ? nt : nrec, resident);
  const int32_t* rec_p = static_cast<const int32_t*>(rec);
  int nrec_i = static_cast<int>(nrec), nt_i = static_cast<int>(nt);
  int32_t* root_p = static_cast<int32_t*>(root);
  int32_t* max_p = static_cast<int32_t*>(chunk_max);
  void* args[] = {&rec_p, &nrec_i, &r, &nt_i, &root_p, &max_p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(expand_indexed_kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// is_lit, payload, starts: (ntok,) int32; stored_out: (nt,) uint8;
// stored_mask: (nt,) bool; root: (nt,) int32 out.
extern "C" int compu_inflate_expand_foreign(const void* is_lit, const void* payload,
                                            const void* starts, long long ntok,
                                            const void* stored_out, const void* stored_mask,
                                            long long nt, void* root, void* stream) {
  if (nt <= 0) return 0;
  if (ntok < 0 || ntok >= (1LL << 31) - 32 || nt >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(kForeignChunk) * (kForeignThreads / 32);
  long long blocks = (nt + per_block - 1) / per_block;
  if (blocks > 4096) blocks = 4096;
  expand_foreign_kernel<<<static_cast<unsigned>(blocks), kForeignThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(is_lit), static_cast<const int32_t*>(payload),
      static_cast<const int32_t*>(starts), static_cast<int>(ntok),
      static_cast<const uint8_t*>(stored_out), static_cast<const bool*>(stored_mask),
      static_cast<int>(nt), static_cast<int32_t*>(root));
  return static_cast<int>(cudaGetLastError());
}

// root: (nt,) int32 in; ns: (nt / n,) int32 or null; scan_ok: (1,) bool or
// null; scratch: (2 nt + 2 ksub + kMaxGrid + kCtrWords,) int32; out: (nt,)
// uint8; ok: (1,) int32; rounds: (2,) int32.
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
  const int resident = resident_blocks(resolve_kernel, kThreads, cache, &err);
  if (!resident) return static_cast<int>(err);
  ResolveArgs a;
  int32_t* s = static_cast<int32_t*>(scratch);
  a.root_in = static_cast<const int32_t*>(root);
  a.nt = static_cast<int>(nt);
  a.n = static_cast<int>(n < nt ? n : nt);
  a.ns = static_cast<const int32_t*>(ns);
  a.scan_ok = static_cast<const bool*>(scan_ok);
  a.max_iters = max_iters;
  a.ksub = static_cast<int>(ksub);
  a.x = s;
  a.y = s + nt;
  a.cand = s + 2 * nt;
  a.sub = s + 2 * nt + ksub;
  a.bcnt = s + 2 * nt + 2 * ksub;
  a.ctr = a.bcnt + kMaxGrid;
  a.out = static_cast<uint8_t*>(out);
  a.ok = static_cast<int32_t*>(ok);
  a.rounds = static_cast<int32_t*>(rounds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.ctr, 0, kCtrWords * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(resolve_kernel),
                                    dim3(grid_for(nt, resident)), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
