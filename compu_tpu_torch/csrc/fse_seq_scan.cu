// The interleaved FSE state chains of a zstd sequences section, P1.
//
// Replaces: the jax.lax.scan in compu_tpu/kernels/zstd_seq_jax.py
// (_seq_bitstream, the state scan). Not a TPU kernel: XLA ran the scan as
// one while loop. Plain version: compu_tpu_torch/kernels/zstd_seq.py
// fse_seq_scan_torch.
//
// Each of the three channels (0 literal lengths, 1 match lengths, 2
// offsets) has an FSE encode table: state_table (<= 512 entries),
// delta_nbits and delta_find (<= 64 symbols), and its table_log. The
// encoder walks the sequences backward. Step j (j = 0 .. nseq-2) codes the
// symbol of sequence i = nseq-2-j:
//   nb       = (state + delta_nbits[sym]) >> 16
//   push     = (state, nb)               // the low nb bits of state
//   state    = state_table[clip((state >> max(nb, 0)) + delta_find[sym], 0, 511)]
// A channel whose table is absent (ens == 0: RLE mode) keeps its state and
// pushes 0 bits. Rows j >= nseq-1 hold the final state and 0 bits, as the
// reference's masked scan over the padded length does.
//
// Bound on the H100: latency. Each step's state is the previous step's
// table read, so a channel is a chain of nseq-1 dependent shared-memory
// reads plus the integer ops between them; the three channels run side by
// side in three lanes of one warp. Device-memory traffic (12 bytes in and
// 24 out per step) is negligible beside the chain.
//
// Design: a transition table per (channel, symbol, state), so that a step
// is one indexed shared read and two integer ops. An encode state lies in
// [2^log, 2^(log+1)), so with u = state - 2^log the whole step for symbol s
// is a function of (s, u). A prologue run by every thread of the block
// builds, for each enabled channel c, symbol s < kSyms[c] and u < 2^log,
// the 16-bit entry
//   e = 2 * (next - 2^log) | nb << 12
// with the twin's nb, clamp and max(nb, 0), in dynamic shared memory (at
// most (36 + 53 + 32) x 512 entries, 123,904 bytes, reserved whole so that
// the host never reads the table logs). The chain keeps off = 2u, a byte
// offset into its symbol's row: a step is
//   e = T[row(sym) + off]; push (off / 2 + 2^log, e >> 12); off = e & 0x3FE.
// The row's byte address, 2 * (channel base + sym << log), is staged per
// step by the other warps into a double-buffered shared chunk while warp 0
// walks the previous chunk; the chain lanes push into a shared ring, which
// the other warps write out to push_v / push_b with coalesced stores, so
// the chain lanes issue no global access.
//
// Precondition (the encoder meets it: it codes only symbols its own tables
// count, and init_state gives states in range): each enabled channel's
// initial state lies in [2^log, 2^(log+1)), and every symbol it codes has a
// non-zero count in its table (so delta_find and state_table send a state
// in range to a state in range). The table covers only those: for any
// other input the kernel stays inside its buffers (states and symbols are
// masked and clamped into the table) but may differ from the twin.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kStbl = 512;   // largest table (table_log <= 9)
constexpr int kNsym = 64;    // the padded alphabet of dnb / df
constexpr int kChunk = 512;  // steps per staged chunk
constexpr int kThreads = 512;
constexpr int kWriters = kThreads - 32;  // warps 1.. stage and write out
// Symbols a channel's rows cover: MAX_{LL,ML,OF}_SYMBOL + 1.
constexpr int kSymsLL = 36, kSymsML = 53, kSymsOF = 32;
constexpr int kTableBytes = (kSymsLL + kSymsML + kSymsOF) * kStbl * 2;

__device__ __forceinline__ int chan_syms(int c) {
  return c == 0 ? kSymsLL : c == 1 ? kSymsML : kSymsOF;
}

__global__ void __launch_bounds__(kThreads)
    fse_seq_scan_kernel(const int32_t* __restrict__ codes, long long P,
                        int nseq, const int32_t* __restrict__ inits,
                        const int32_t* __restrict__ st,
                        const int32_t* __restrict__ dnb,
                        const int32_t* __restrict__ df,
                        const int32_t* __restrict__ ens,
                        const int32_t* __restrict__ logs,
                        int32_t* __restrict__ push_v,
                        int32_t* __restrict__ push_b,
                        int32_t* __restrict__ final_states) {
  extern __shared__ __align__(16) uint16_t s_tab[];
  __shared__ int32_t s_st[3][kStbl];
  __shared__ int32_t s_dnb[3][kNsym];
  __shared__ int32_t s_df[3][kNsym];
  // Row byte address per step; 8 spare entries for the chain's read-ahead.
  __shared__ __align__(16) int32_t s_row[2][3][kChunk + 8];
  __shared__ __align__(16) uint32_t s_ring[2][3][kChunk];  // state | nb << 16
  __shared__ int32_t s_final[3];

  // Channel layout, the same in every thread: log, enabled, first entry.
  int lg[3], base[3];
  bool en[3];
  {
    int at = 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lg[c] = min(max(logs[c], 0), 9);
      en[c] = ens[c] > 0;
      base[c] = at;
      at += en[c] ? chan_syms(c) << lg[c] : 0;
    }
  }
  for (int k = threadIdx.x; k < 3 * kStbl; k += kThreads)
    s_st[k / kStbl][k % kStbl] = st[k];
  for (int k = threadIdx.x; k < 3 * kNsym; k += kThreads) {
    s_dnb[k / kNsym][k % kNsym] = dnb[k];
    s_df[k / kNsym][k % kNsym] = df[k];
  }
  __syncthreads();

  // The prologue: every thread builds entries of every enabled channel.
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!en[c]) continue;
    const int size = 1 << lg[c];
    const int n = chan_syms(c) << lg[c];
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int s = e >> lg[c];
      const int state = size + (e & (size - 1));
      const int nb = (state + s_dnb[c][s]) >> 16;
      const int idx = (state >> max(nb, 0)) + s_df[c][s];
      const int next = s_st[c][min(max(idx, 0), kStbl - 1)];
      s_tab[base[c] + e] =
          static_cast<uint16_t>((((next - size) & (size - 1)) << 1) | ((nb & 15) << 12));
    }
  }
  __syncthreads();

  const long long steps = nseq > 1 ? nseq - 1 : 0;
  const long long nchunks = (steps + kChunk - 1) / kChunk;
  const int lane = threadIdx.x;  // the chain lane's channel, for lane < 3

  // Warps 1.. stage chunk k into buffer k & 1: step j = k*kChunk + t codes
  // the symbol of sequence nseq-2-j.
  auto stage = [&](long long k) {
    const long long j0 = k * kChunk;
    for (int e = threadIdx.x - 32; e < 3 * kChunk; e += kWriters) {
      const int c = e / kChunk, t = e - c * kChunk;
      const long long j = j0 + t;
      int row = 0;
      const int cl = c == 0 ? lg[0] : c == 1 ? lg[1] : lg[2];
      const int cb = c == 0 ? base[0] : c == 1 ? base[1] : base[2];
      if (j < steps) {
        const int sym = min(max(codes[c * P + (nseq - 2 - j)], 0), chan_syms(c) - 1);
        row = 2 * (cb + (sym << cl));
      }
      s_row[k & 1][c][t] = row;
    }
  };
  // Warps 1.. (or every thread, with `first` 0) write chunk k's pushes out.
  auto write_out = [&](long long k, int first, int stride) {
    const long long j0 = k * kChunk;
    const int m = static_cast<int>(steps - j0 < kChunk ? steps - j0 : kChunk);
    for (int e = threadIdx.x - first; e < 3 * m; e += stride) {
      const int t = e / 3, c = e - 3 * t;
      const bool on = c == 0 ? en[0] : c == 1 ? en[1] : en[2];
      const uint32_t r = s_ring[k & 1][c][t];
      push_v[3 * j0 + e] = on ? static_cast<int32_t>(r & 0xFFFF) : inits[c];
      push_b[3 * j0 + e] = on ? static_cast<int32_t>(r >> 16) : 0;
    }
  };

  // The chain lane's state as off = 2 (state - 2^log).
  int off = 0, one = 1;
  bool walk = false;
  if (lane < 3) {
    const int cl = lane == 0 ? lg[0] : lane == 1 ? lg[1] : lg[2];
    walk = lane == 0 ? en[0] : lane == 1 ? en[1] : en[2];
    one = 1 << cl;
    off = ((inits[lane] - one) & (one - 1)) << 1;
  }

  if (threadIdx.x >= 32 && nchunks > 0) stage(0);
  __syncthreads();
  const char* tab = reinterpret_cast<const char*>(s_tab);
  for (long long k = 0; k < nchunks; ++k) {
    if (threadIdx.x >= 32) {
      if (k + 1 < nchunks) stage(k + 1);
      if (k > 0) write_out(k - 1, 32, kWriters);
    } else if (walk) {
      const long long j0 = k * kChunk;
      const int m = static_cast<int>(steps - j0 < kChunk ? steps - j0 : kChunk);
      const int4* rows = reinterpret_cast<const int4*>(s_row[k & 1][lane]);
      uint4* ring = reinterpret_cast<uint4*>(s_ring[k & 1][lane]);
      // Groups of 8 steps; the next group's rows are read ahead.
      int4 n0 = rows[0], n1 = rows[1];
      const int groups = m >> 3;
      for (int g = 0; g < groups; ++g) {
        const int b[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
        n0 = rows[2 * g + 2];
        n1 = rows[2 * g + 3];
        uint32_t p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t e = *reinterpret_cast<const uint16_t*>(tab + b[i] + off);
          p[i] = static_cast<uint32_t>((off >> 1) + one) | (e >> 12) << 16;
          off = static_cast<int>(e & 0x3FE);
        }
        ring[2 * g] = make_uint4(p[0], p[1], p[2], p[3]);
        ring[2 * g + 1] = make_uint4(p[4], p[5], p[6], p[7]);
      }
      const int32_t* row = s_row[k & 1][lane];
      uint32_t* ring1 = s_ring[k & 1][lane];
      for (int t = groups << 3; t < m; ++t) {
        const uint32_t e = *reinterpret_cast<const uint16_t*>(tab + row[t] + off);
        ring1[t] = static_cast<uint32_t>((off >> 1) + one) | (e >> 12) << 16;
        off = static_cast<int>(e & 0x3FE);
      }
    }
    __syncthreads();
  }
  if (lane < 3) s_final[lane] = walk ? (off >> 1) + one : inits[lane];
  if (nchunks > 0) write_out(nchunks - 1, 0, kThreads);
  __syncthreads();

  // Rows past the last step: the final state, 0 bits.
  for (long long e = steps * 3 + threadIdx.x; e < P * 3; e += kThreads) {
    push_v[e] = s_final[e % 3];
    push_b[e] = 0;
  }
  if (lane < 3) final_states[lane] = s_final[lane];
}

}  // namespace

// The dynamic shared memory the kernel asks for, in bytes.
extern "C" int compu_fse_seq_scan_smem() { return kTableBytes; }

// codes: (3, P) i32 symbols in sequence order (LL, ML, OF rows); inits,
// ens, logs: (3,) i32; st: (3, 512) i32; dnb, df: (3, 64) i32; push_v,
// push_b: (P, 3) i32; final_states: (3,) i32. 1 <= nseq <= P; the
// precondition above.
extern "C" int compu_fse_seq_scan(const void* codes, long long P, int nseq,
                                  const void* inits, const void* st,
                                  const void* dnb, const void* df,
                                  const void* ens, const void* logs,
                                  void* push_v, void* push_b,
                                  void* final_states, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fse_seq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fse_seq_scan_kernel<<<1, kThreads, kTableBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), P, nseq,
      static_cast<const int32_t*>(inits), static_cast<const int32_t*>(st),
      static_cast<const int32_t*>(dnb), static_cast<const int32_t*>(df),
      static_cast<const int32_t*>(ens), static_cast<const int32_t*>(logs),
      static_cast<int32_t*>(push_v), static_cast<int32_t*>(push_b),
      static_cast<int32_t*>(final_states));
  return static_cast<int>(cudaGetLastError());
}
