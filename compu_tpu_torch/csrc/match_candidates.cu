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
// zero bytes of the XOR, word by word, stopping at the first word that
// differs. A later d replaces the best only on a strictly longer length, so
// equal lengths keep the nearest lane in sort order.
//
// Bound on the H100: memory. Each lane reads (2 + nwords) 32-bit values and
// writes two; the depth * nwords compare steps per lane run on shared
// memory, far below the card's integer rate.
//
// Design: one thread per lane. A block stages hs, ps and the word rows of
// its 256-lane tile plus a backward halo of depth lanes in shared memory,
// with coalesced loads, so every neighbour read hits shared memory. The TPU
// kernel carried its halo from one grid step to the next; here each block
// loads its own. The halo is sized at launch: (256 + depth) * (2 + nwords)
// 32-bit values, opted in above 48 KB.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kMaxWords = 8;

__device__ __forceinline__ int trailing_zero_bytes(uint32_t x) {
  return __clz(static_cast<int>(__brev(x))) >> 3;  // __clz(0) == 32: 0 gives 4
}

__global__ void match_kernel(const int32_t* __restrict__ hs,
                             const int32_t* __restrict__ ps,
                             const uint32_t* __restrict__ words, int nwords,
                             int32_t* __restrict__ best_len,
                             int32_t* __restrict__ best_dist, long long n,
                             long long block_mask, int depth, int max_dist) {
  extern __shared__ int32_t smem[];
  const int span = kTile + depth;
  int32_t* s_hs = smem;
  int32_t* s_ps = smem + span;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + 2 * span);
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long long g = tile0 - depth + t;
    const bool inside = g >= 0 && g < n;
    s_hs[t] = inside ? hs[g] : 0;
    s_ps[t] = inside ? ps[g] : 0;
    for (int k = 0; k < nwords; ++k) {
      s_w[k * span + t] = inside ? words[k * n + g] : 0u;
    }
  }
  __syncthreads();
  const long long i = tile0 + threadIdx.x;
  if (i >= n) return;
  const int c = threadIdx.x + depth;
  const int h = s_hs[c];
  const int p = s_ps[c];
  uint32_t w[kMaxWords];
#pragma unroll
  for (int k = 0; k < kMaxWords; ++k) w[k] = k < nwords ? s_w[k * span + c] : 0u;
  const long long lpos = i & block_mask;
  const int dmax = lpos < depth ? static_cast<int>(lpos) : depth;
  int bl = 0, bd = 0;
  for (int d = 1; d <= dmax; ++d) {
    const int j = c - d;
    if (s_hs[j] != h) continue;
    const int dist = p - s_ps[j];
    if (dist <= 0 || dist > max_dist) continue;
    int l = 0;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      if (k >= nwords) break;
      const int lk = trailing_zero_bytes(w[k] ^ s_w[k * span + j]);
      l += lk;
      if (lk < 4) break;
    }
    if (l > bl) {
      bl = l;
      bd = dist;
    }
  }
  best_len[i] = bl;
  best_dist[i] = bd;
}

}  // namespace

// hs, ps, best_len, best_dist: (n,) i32; words: (nwords, n) u32 bit patterns.
// block_elems is a power of two dividing n; 1 <= nwords <= 8; depth >= 1.
extern "C" int compu_match_candidates(const void* hs, const void* ps,
                                      const void* words, int nwords,
                                      void* best_len, void* best_dist,
                                      long long n, long long block_elems,
                                      int depth, int max_dist, void* stream) {
  if (nwords < 1 || nwords > kMaxWords || depth < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(kTile + depth) * (2 + nwords) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  match_kernel<<<blocks, kTile, smem, s>>>(
      static_cast<const int32_t*>(hs), static_cast<const int32_t*>(ps),
      static_cast<const uint32_t*>(words), nwords,
      static_cast<int32_t*>(best_len), static_cast<int32_t*>(best_dist), n,
      block_elems - 1, depth, max_dist);
  return static_cast<int>(cudaGetLastError());
}
