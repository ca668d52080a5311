// Batched SHA-1 over host-padded rows, hand-written for Hopper (sm_90a).
//
// Replaces torrent_tpu/ops/sha1_pallas.py::_sha1_kernel (pallas_call at
// sha1_pallas.py:243). Same contract: rows already padded on the host
// (ops/padding.py), one int32 block count per row, five big-endian state
// words per row out. A row with nblocks = 0 is a sentinel: its chain
// never runs and it writes the IV, as the reference does.
//
// Translation. The TPU kernel walks the chain as a sequential grid axis
// and keeps the running state in a revisited VMEM block; Pallas tiles
// 32 x 128 pieces per program so each schedule word fills vector lanes.
// Here one thread owns one piece: the loop over its blocks replaces the
// serial grid axis, and the state and the 16-word schedule window live
// in registers for the whole chain. Rotates are __funnelshift_l, the
// byteswap of the host-order words is __byte_perm, and ch/maj are written
// in the mux/factored forms the reference uses (sha1_pallas.py:100-111),
// which nvcc turns into one LOP3 each.
//
// What bounds it on an H100. Per 64-byte block the chain needs 613
// integer instructions (ops/sha1_cuda.py OPS_PER_BLOCK: 16 byteswaps,
// 64 x 3 for the schedule, 80 x 5 for the rounds, 5 for the feed-forward)
// against 64 bytes of input, so the work is integer-ALU bound, not memory
// bound: 9.6 ops per byte, where the card's INT32 rate over its memory
// rate is 5. Within a piece the chain is serial, so the only parallelism
// is the batch: at B = 4096 pieces that is 128 warps, about one per SM,
// and the kernel is held back by the latency of each round's dependent
// rotate-and-add far more than by either peak. What this design does
// about it:
//   - 32-thread blocks, so even 4096 rows spread over ~128 of the 132 SMs;
//   - each block is fetched as four 16-byte loads, and the next block is
//     loaded while the current one is compressed, which hides most of the
//     load latency that one warp per SM cannot hide by switching warps;
//   - neighbouring threads' rows are a whole row apart, so loads do not
//     coalesce; 16-byte vector loads still use each 32-byte sector in
//     full. Staging blocks through shared memory (cp.async / TMA) is left
//     for a later change.
// Row offsets are 64-bit: 4096 rows of 1 MiB pieces span 4.3 GB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// Little-endian load of bytes b0 b1 b2 b3 -> big-endian word b0b1b2b3.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void compress(uint32_t st[5], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      // w[t-3] ^ w[t-8] ^ w[t-14] ^ w[t-16] on a 16-word rolling window
      wt = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^ w[t & 15], 1);
      w[t & 15] = wt;
    }
    uint32_t f, k;
    if (t < 20) {
      f = d ^ (b & (c ^ d));  // ch
      k = 0x5A827999u;
    } else if (t < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (t < 60) {
      f = (b & c) | (d & (b ^ c));  // maj
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t tmp = rotl(a, 5) + f + e + k + wt;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = tmp;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
}

__global__ void __launch_bounds__(kThreads)
sha1_rows_kernel(const uint8_t* __restrict__ data, int64_t row_bytes,
                 const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out,
                 int64_t batch) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= batch) return;
  const int64_t max_blocks = row_bytes / 64;
  int64_t n = nblocks[row];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);

  uint32_t st[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};
  const uint4* p = reinterpret_cast<const uint4*>(data + row * row_bytes);
  if (n > 0) {
    uint4 cur[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = __ldg(p + i);
    for (int64_t blk = 0; blk < n; ++blk) {
      // prefetch the next block (the last block reloads itself: no branch)
      const int64_t nxt_blk = blk + 1 < n ? blk + 1 : blk;
      uint4 nxt[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) nxt[i] = __ldg(p + nxt_blk * 4 + i);
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[4 * i + 0] = bswap(cur[i].x);
        w[4 * i + 1] = bswap(cur[i].y);
        w[4 * i + 2] = bswap(cur[i].z);
        w[4 * i + 3] = bswap(cur[i].w);
      }
      compress(st, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) out[row * 5 + i] = st[i];
}

}  // namespace

extern "C" {

// data:     batch rows of row_bytes each (uint8, or host-order uint32 with
//           the same bytes), 16-byte aligned, row_bytes a multiple of 64
// nblocks:  int32[batch], clamped to [0, row_bytes / 64]
// out:      uint32[batch, 5], big-endian state words
// stream:   cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 = launched).
int tt_sha1_launch(const void* data, int64_t row_bytes, const void* nblocks,
                   void* out, int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 64 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (batch + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  sha1_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), row_bytes,
      static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
