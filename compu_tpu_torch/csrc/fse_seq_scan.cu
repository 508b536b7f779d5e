// The interleaved FSE state chains of a zstd sequences section.
//
// Replaces: the jax.lax.scan in compu_tpu/kernels/zstd_seq_jax.py
// (_seq_bitstream, the state scan). Not a TPU kernel: XLA ran the scan as
// one while loop. Plain version: compu_tpu_torch/kernels/zstd_seq.py
// fse_seq_scan_torch.
//
// Each of the three channels (0 literal lengths, 1 match lengths, 2
// offsets) has an FSE encode table: state_table (<= 512 entries),
// delta_nbits and delta_find (<= 64 symbols). The encoder walks the
// sequences backward. Step j (j = 0 .. nseq-2) codes the symbol of
// sequence i = nseq-2-j:
//   nb       = (state + delta_nbits[sym]) >> 16
//   push     = (state, nb)               // the low nb bits of state
//   state    = state_table[clip((state >> nb) + delta_find[sym], 0, 511)]
// A channel whose table is absent (ens == 0: RLE mode) keeps its state and
// pushes 0 bits. Rows j >= nseq-1 hold the final state and 0 bits, as the
// reference's masked scan over the padded length does.
//
// Bound on the H100: latency. Each step's state is the previous step's
// table read, so a channel is a chain of nseq-1 dependent shared-memory
// reads plus the integer ops between them; the three channels run side by
// side. Device-memory traffic (12 bytes in and 24 out per step) is
// negligible beside the chain: ~7,000 steps a 128 KiB block at tens of
// cycles each.
//
// Design: one launch per sequences section, one block of two warps. The
// tables sit in shared memory. Warp 1 stages the symbols' delta_nbits and
// delta_find per step into a double-buffered shared chunk of kChunk steps
// while lanes 0-2 of warp 0 walk the previous chunk, one channel a lane,
// so the chain reads only shared memory and never waits on device memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStbl = 512;   // largest table (table_log <= 9)
constexpr int kNsym = 64;    // largest alphabet (ML has 53 symbols)
constexpr int kChunk = 512;  // steps per staged chunk
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    fse_seq_scan_kernel(const int32_t* __restrict__ codes, long long P,
                        int nseq, const int32_t* __restrict__ inits,
                        const int32_t* __restrict__ st,
                        const int32_t* __restrict__ dnb,
                        const int32_t* __restrict__ df,
                        const int32_t* __restrict__ ens,
                        int32_t* __restrict__ push_v,
                        int32_t* __restrict__ push_b,
                        int32_t* __restrict__ final_states) {
  __shared__ int32_t s_st[3][kStbl];
  __shared__ int32_t s_dnb[3][kNsym];
  __shared__ int32_t s_df[3][kNsym];
  __shared__ int32_t s_dn[2][3][kChunk];  // delta_nbits[sym] per step
  __shared__ int32_t s_fd[2][3][kChunk];  // delta_find[sym] per step
  for (int k = threadIdx.x; k < 3 * kStbl; k += kThreads)
    s_st[k / kStbl][k % kStbl] = st[k];
  for (int k = threadIdx.x; k < 3 * kNsym; k += kThreads) {
    s_dnb[k / kNsym][k % kNsym] = dnb[k];
    s_df[k / kNsym][k % kNsym] = df[k];
  }
  __syncthreads();

  const long long steps = nseq > 1 ? nseq - 1 : 0;
  const long long nchunks = (steps + kChunk - 1) / kChunk;
  const int lane = threadIdx.x;  // the chain lane's channel, for lane < 3
  int state = 0;
  bool en = false;
  if (lane < 3) {
    state = inits[lane];
    en = ens[lane] > 0;
  }

  // Warp 1 stages chunk k into buffer k & 1: step j = k*kChunk + t codes
  // the symbol of sequence nseq-2-j.
  auto stage = [&](long long k) {
    const int w = threadIdx.x - 32;
    const long long j0 = k * kChunk;
    for (int e = w; e < 3 * kChunk; e += 32) {
      const int c = e / kChunk, t = e - c * kChunk;
      const long long j = j0 + t;
      int dn = 0, fd = 0;
      if (j < steps) {
        const int sym = codes[c * P + (nseq - 2 - j)];
        dn = s_dnb[c][sym];
        fd = s_df[c][sym];
      }
      s_dn[k & 1][c][t] = dn;
      s_fd[k & 1][c][t] = fd;
    }
  };

  if (threadIdx.x >= 32 && nchunks > 0) stage(0);
  __syncthreads();
  for (long long k = 0; k < nchunks; ++k) {
    if (threadIdx.x >= 32) {
      if (k + 1 < nchunks) stage(k + 1);
    } else if (lane < 3) {
      const long long j0 = k * kChunk;
      const int m = static_cast<int>(steps - j0 < kChunk ? steps - j0 : kChunk);
      const int32_t* dn = s_dn[k & 1][lane];
      const int32_t* fd = s_fd[k & 1][lane];
      const int32_t* tab = s_st[lane];
      int32_t* pv = push_v + 3 * j0 + lane;
      int32_t* pb = push_b + 3 * j0 + lane;
      if (en) {
#pragma unroll 8
        for (int t = 0; t < m; ++t) {
          const int nb = (state + dn[t]) >> 16;
          pv[3 * t] = state;
          pb[3 * t] = nb;
          const int idx = (state >> max(nb, 0)) + fd[t];
          state = tab[min(max(idx, 0), kStbl - 1)];
        }
      } else {
        for (int t = 0; t < m; ++t) {
          pv[3 * t] = state;
          pb[3 * t] = 0;
        }
      }
    }
    __syncthreads();
  }

  // Rows past the last step: the final state, 0 bits.
  for (long long e = steps * 3 + threadIdx.x; e < P * 3; e += kThreads) {
    push_b[e] = 0;
  }
  if (lane < 3) {
    for (long long j = steps; j < P; ++j) push_v[3 * j + lane] = state;
    final_states[lane] = state;
  }
}

}  // namespace

// codes: (3, P) i32 symbols in sequence order (LL, ML, OF rows); inits,
// ens: (3,) i32; st: (3, 512) i32; dnb, df: (3, 64) i32; push_v, push_b:
// (P, 3) i32; final_states: (3,) i32. 1 <= nseq <= P; every symbol of the
// first nseq - 1 sequences < 64.
extern "C" int compu_fse_seq_scan(const void* codes, long long P, int nseq,
                                  const void* inits, const void* st,
                                  const void* dnb, const void* df,
                                  const void* ens, void* push_v, void* push_b,
                                  void* final_states, void* stream) {
  fse_seq_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), P, nseq,
      static_cast<const int32_t*>(inits), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(dnb), static_cast<const int32_t*>(df),
      static_cast<const int32_t*>(ens), static_cast<int32_t*>(push_v),
      static_cast<int32_t*>(push_b), static_cast<int32_t*>(final_states));
  return static_cast<int>(cudaGetLastError());
}
