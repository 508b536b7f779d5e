// Segment-local bit pack of the emit stage.
//
// Replaces: compu_tpu/kernels/emit_pallas.py:_emit_kernel (via
// emit_pack_pallas; its XLA twin emit_pack_xla + rows_from_tiles is what the
// reference's emit runs). Plain twin: compu_tpu_torch/kernels/emit_pack.py
// emit_pack_torch.
//
// Each segment owns a 512-byte row. Field f of segment s holds a u32 value
// already shifted to its bit phase; byte k of it is ADDED at row byte
// bytep[s, f] + k, and bytes at or past 512 are dropped (so is a field with
// bytep outside [0, 512)). Fields share bytes but never bits, so the sums
// equal an OR; adding keeps a fault in that disjointness visible the same
// way on the kernel and on the reference.
//
// Bound on the H100: memory. Per segment it reads 2 KiB of fields and
// writes 2 KiB of row (at 256 fields); the byte adds are a few operations
// per field.
//
// Design: one warp per segment, 8 segments per 256-thread block, so a
// block keeps 8 rows in shared memory and an SM has up to 64 segments in
// flight. A lane loads 4 fields at once (16-byte loads of bytep and
// shifted), two such groups before it adds, and the warp stores the row
// with 16-byte stores. Before touching shared memory a lane adds, in
// registers, the bytes of its 4 fields that land within 8 bytes of its
// first field (16-bit slots, which cannot carry: a slot sums at most 4
// bytes), then adds each non-zero slot once; a zero byte is never added.
// That turns the 16 byte adds of a group into about as many shared
// atomics as the group has distinct bytes. A field outside that window
// adds its own bytes. Rows whose fields are not 16-byte aligned (nfields
// not a multiple of 4) take scalar loads for their unaligned head and tail.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 512;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ bool in_row(int p) { return p >= 0 && p < kRow; }

// One field on its own: byte k of v added at row[p + k].
__device__ __forceinline__ void add_field(int32_t* row, int p, uint32_t v) {
  if (!in_row(p) || v == 0) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int b = (v >> (8 * k)) & 0xFF;
    if (b != 0 && p + k < kRow) atomicAdd(&row[p + k], b);
  }
}

// Four fields: those within the 8-byte window from p[0] combined in
// registers first.
__device__ __forceinline__ void add_group(int32_t* row, int4 p4, int4 v4) {
  const int p[4] = {p4.x, p4.y, p4.z, p4.w};
  const uint32_t v[4] = {static_cast<uint32_t>(v4.x), static_cast<uint32_t>(v4.y),
                         static_cast<uint32_t>(v4.z), static_cast<uint32_t>(v4.w)};
  const int base = p[0];
  uint64_t lo = 0, hi = 0;  // window bytes base..base+3 and base+4..base+7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int off = p[j] - base;
    if (in_row(base) && in_row(p[j]) && off >= 0 && off <= 4) {
      // The field's 4 bytes as 16-bit lanes, moved up by off lanes.
      const uint64_t e = (static_cast<uint64_t>(__byte_perm(v[j], 0, 0x4342)) << 32) |
                         __byte_perm(v[j], 0, 0x4140);
      const int sh = 16 * off;
      lo += sh < 64 ? e << sh : 0;
      hi += sh > 0 ? e >> (64 - sh) : 0;
    } else {
      add_field(row, p[j], v[j]);
    }
  }
  if ((lo | hi) == 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = static_cast<int>(((i < 4 ? lo : hi) >> (16 * (i & 3))) & 0xFFFF);
    if (b != 0 && base + i < kRow) atomicAdd(&row[base + i], b);
  }
}

__global__ void __launch_bounds__(kThreads)
    emit_pack_kernel(const int32_t* __restrict__ bytep,
                     const int32_t* __restrict__ shifted,
                     int32_t* __restrict__ rows, long long nseg, int nfields,
                     bool vec) {
  __shared__ int4 s_rows[kWarps][kRow / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long s = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (s >= nseg) return;  // the whole warp; the block never synchronises
  int4* row4 = s_rows[warp];
  int32_t* row = reinterpret_cast<int32_t*>(row4);
  for (int t = lane; t < kRow / 4; t += 32) row4[t] = make_int4(0, 0, 0, 0);
  __syncwarp();

  // Fields [f0, f1) of the flat arrays; [a0, a1) is the 16-byte aligned
  // run read 4 at a time, the rest field by field.
  const long long f0 = s * nfields, f1 = f0 + nfields;
  long long a0 = f1, a1 = f1;
  if (vec) {
    a0 = min((f0 + 3) & ~3LL, f1);
    a1 = max(a0, f1 & ~3LL);
  }
  const int4* p4 = reinterpret_cast<const int4*>(bytep + a0);
  const int4* v4 = reinterpret_cast<const int4*>(shifted + a0);
  const long long groups = (a1 - a0) / 4;
  for (long long g = lane; g < groups; g += 64) {
    const bool second = g + 32 < groups;
    const int4 pa = __ldg(p4 + g), va = __ldg(v4 + g);
    int4 pb = make_int4(0, 0, 0, 0), vb = pb;
    if (second) {
      pb = __ldg(p4 + g + 32);
      vb = __ldg(v4 + g + 32);
    }
    add_group(row, pa, va);
    if (second) add_group(row, pb, vb);
  }
  for (long long f = f0 + lane; f < a0; f += 32) {
    add_field(row, __ldg(bytep + f), static_cast<uint32_t>(__ldg(shifted + f)));
  }
  for (long long f = a1 + lane; f < f1; f += 32) {
    add_field(row, __ldg(bytep + f), static_cast<uint32_t>(__ldg(shifted + f)));
  }
  __syncwarp();

  int4* dst = reinterpret_cast<int4*>(rows + s * kRow);
  for (int t = lane; t < kRow / 4; t += 32) dst[t] = row4[t];
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// bytep, shifted: (nseg, nfields) i32 (shifted as u32 bit patterns);
// rows: (nseg, 512) i32, 16-byte aligned.
extern "C" int compu_emit_pack(const void* bytep, const void* shifted,
                               void* rows, long long nseg, int nfields,
                               void* stream) {
  if (!aligned16(rows)) return static_cast<int>(cudaErrorMisalignedAddress);
  const bool vec = aligned16(bytep) && aligned16(shifted);
  const unsigned blocks = static_cast<unsigned>((nseg + kWarps - 1) / kWarps);
  emit_pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bytep), static_cast<const int32_t*>(shifted),
      static_cast<int32_t*>(rows), nseg, nfields, vec);
  return static_cast<int>(cudaGetLastError());
}
