// Batched SHA-256 over host-padded rows, and merkle reductions,
// hand-written for Hopper (sm_90a).
//
// Replaces torrent_tpu/ops/sha256_pallas.py::_sha256_kernel (pallas_call at
// sha256_pallas.py:275) and, as a second entry point of the same source,
// the XLA merkle reduction torrent_tpu/models/merkle.py::_merkle_reduce_fused
// (every pair level of a tree in one dispatch) that the reference runs
// outside any Pallas kernel.
//
// Rows (tt_sha256_launch). Same contract as the TPU kernel: rows already
// padded on the host (ops/padding.py), one int32 block count per row,
// eight big-endian state words per row out. A row with nblocks = 0 is a
// sentinel: its chain never runs and it writes the IV.
//
// Merkle (tt_sha256_merkle_launch). Each run of 2^levels consecutive 8-word
// nodes reduces to its root by `levels` pair levels. A pair is the 64-byte
// concatenation of two child digests as sixteen big-endian words (digests
// never leave word form above the leaves, so there is no byteswap), and its
// SHA-256 is the compression of that block followed by the constant padding
// block 0x80000000, 0 x 14, 512. The trees of a [B, L, 8] grid are
// contiguous, so the grid viewed as [B*L, 8] reduces to [B, 8] in one launch
// when log2(L) <= kMerkleCap; taller trees take ceil(levels / cap) launches
// (ops/sha256_cuda.py merkle_passes). One merkle level, `levels` = 1, is the
// pair level models/merkle.py::sha256_pairs.
//
// Translation. The TPU kernel tiles 8-32 x 128 rows per program and walks
// the chain as an "arbitrary" grid axis with the state in a revisited VMEM
// block. Here one thread owns one row: the loop over its blocks replaces
// the grid axis, and the 8-word state and the 16-word schedule window stay
// in registers for the whole chain. The 64 rounds are fully unrolled, so
// every schedule index is static and the round constants are constant-bank
// operands of the adds (K lives in __constant__ memory; with constant
// indices nvcc folds each read into the IADD3 that uses it). Rotates are
// __funnelshift_r, ch and maj are the mux/factored forms nvcc turns into one
// LOP3 each, and the host-order words are byteswapped with __byte_perm. In
// a merkle pair the second block's schedule is a compile-time constant,
// which nvcc folds away.
//
// What bounds it on an H100. Per 64-byte block the chain needs about 1,400
// integer instructions (ops/work.py SHA256_BLOCK_OPS): 16 byteswaps;
// 48 schedule words of 10 (sigma0 and sigma1 each two SHF, one SHR and one
// LOP3, plus two IADD3); 64 rounds of 14 (Sigma0 and Sigma1 each three SHF
// and one LOP3, ch and maj one LOP3 each, four adds); 8 feed-forward adds.
// That is 21.9 ops per byte, where the card's INT32 rate over its memory
// rate is 5, so the kernel is integer-ALU bound. The chain is serial
// within a row, so the batch is the only parallelism: a 32768-leaf launch
// is 1024 warps, under 8 per SM, and the dependent round chain's latency
// is what holds it back. The design, as in csrc/sha1.cu:
//   - 32-thread blocks for rows, so even small batches spread over SMs;
//   - each block is four 16-byte __ldg loads, and the next block is loaded
//     while the current one is compressed;
//   - neighbouring rows are 16,512 bytes apart (a padded 16 KiB leaf), so
//     loads do not coalesce; 16-byte loads still use each sector in full.
//     Shared-memory staging (cp.async / TMA) is left for a later change.
// Row offsets are 64-bit.
//
// The merkle reduction is bound the same way: a pair is 2,288 integer
// instructions (MERKLE_PAIR_OPS) on 64 bytes in and 32 out. An SM sub-partition
// has 16 INT32 lanes, so one warp issues an integer instruction every two
// cycles at best: one pair level costs a warp at least 4,600 cycles whatever
// else runs (tools/time_merkle.py measured about 4,900 a level, the slope
// of the device time between one-tree launches of 1 and 6 levels, on an
// NVIDIA H100 80GB HBM3 at 700 W: near that limit), and a tree's levels
// are a dependent chain of such steps. Two things follow for the design:
//   - a lane that has nothing to hash at a level saves no issue slot; only
//     a warp with no live lane does. So each level is packed into the
//     fewest warps: a CTA of kMerkleThreads threads takes 2 * kMerkleThreads
//     consecutive nodes (whole trees, or a slice of one tall tree), thread t
//     hashes pair t of the level, and the level's nodes go through a
//     double-buffered shared-memory array (one __syncthreads a level) to the
//     first half of the threads for the next level. Level k then issues
//     ceil(kMerkleThreads / 2^(k-1) / 32) warps, 17 warp-levels for the 63
//     pairs of each 64-leaf tree of a full CTA against 48 if a warp reduced
//     its own 64 leaves with shuffles, where every warp runs all six levels
//     with most lanes idle;
//   - a CTA's first level runs its kMerkleThreads / 32 warps on one SM's four
//     sub-partitions, so a taller CTA makes level 1 issue-bound on one SM: 8
//     warps are two a sub-partition (about 9,200 cycles), 32 warps eight
//     (about 37,000). The cap is 8 warps, 512 nodes, 9 levels a launch. A
//     2 GiB file's 2048-piece layer (11 levels) is then two launches, 6 + 5
//     levels, the first spread over 4 SMs, about 12 pair-steps of chain
//     against 22 for one 1024-thread CTA.
// Level 1 reads each thread's 64 bytes as four 16-byte __ldg loads: a warp
// reads 2 KiB, contiguous. A ragged last CTA holds whole trees only (the
// node count is a multiple of 2^levels), and every load and store is
// guarded by node index.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The rows kernel's block is a compile-time parameter, so that
// torrent_tpu_torch/tools/tune_sha256.py can build variants with -D flags
// (ops/sha256_cuda.py::load_variant); the default is the production one.
#ifndef TT_SHA256_ROW_THREADS
#define TT_SHA256_ROW_THREADS 32
#endif

constexpr int kRowThreads = TT_SHA256_ROW_THREADS;  // threads (rows) a block
static_assert(kRowThreads % 32 == 0 && kRowThreads >= 32 && kRowThreads <= 1024,
              "a rows block is whole warps, at most 1024 threads");
constexpr int kMerkleThreads = 256;              // 8 warps a CTA
constexpr int kMerkleSpan = 2 * kMerkleThreads;  // input nodes a CTA reduces
constexpr int kMerkleCap = 9;                    // log2(kMerkleSpan): levels a launch

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Little-endian load of bytes b0 b1 b2 b3 -> big-endian word b0b1b2b3.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void init_state(uint32_t st[8]) {
  st[0] = 0x6A09E667u;
  st[1] = 0xBB67AE85u;
  st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu;
  st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu;
  st[7] = 0x5BE0CD19u;
}

// One SHA-256 compression (FIPS 180-4 6.2.2) on a 16-word rolling window.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t + 1) & 15];
      const uint32_t w2 = w[(t + 14) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t + 9) & 15] + s1;
    }
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = g ^ (e & (f ^ g));
    const uint32_t t1 = h + big_s1 + ch + kK[t] + w[t & 15];
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) | (c & (a ^ b));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big_s0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

__global__ void __launch_bounds__(kRowThreads)
sha256_rows_kernel(const uint8_t* __restrict__ data, int64_t row_bytes,
                   const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out,
                   int64_t batch) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (row >= batch) return;
  const int64_t max_blocks = row_bytes / 64;
  int64_t n = nblocks[row];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);

  uint32_t st[8];
  init_state(st);
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
  for (int i = 0; i < 8; ++i) out[row * 8 + i] = st[i];
}

// The parent of two child digests: SHA-256 of their 64-byte concatenation
// w, i.e. the pair block, then the constant padding block of a 64-byte
// message (0x80, zeros, bit length 512).
__device__ __forceinline__ void hash_pair(uint32_t w[16], uint32_t st[8]) {
  init_state(st);
  compress(st, w);
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 512u};
  compress(st, pad);
}

__global__ void __launch_bounds__(kMerkleThreads)
sha256_merkle_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                     int64_t nodes, int levels) {
  // the nodes of the last level, as two uint4 each, in two buffers that
  // alternate from level to level: 2 x 8 KiB
  __shared__ uint4 level_nodes[2][kMerkleSpan];
  const int t = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kMerkleSpan;
  uint32_t st[8];
  bool live = false;
  for (int level = 1; level <= levels; ++level) {
    uint4* buf = level_nodes[level & 1];
    if (level > 1) {
      // hand the last level's nodes to the first half of the threads
      if (live) {
        buf[2 * t] = make_uint4(st[0], st[1], st[2], st[3]);
        buf[2 * t + 1] = make_uint4(st[4], st[5], st[6], st[7]);
      }
      __syncthreads();
    }
    // pair t of this level covers input nodes [first + t 2^level, + 2^level),
    // all of them present or none (whole trees)
    live = t < (kMerkleSpan >> level) && first + (static_cast<int64_t>(t) << level) < nodes;
    if (live) {
      uint4 v[4];
      if (level == 1) {
        const uint4* p = reinterpret_cast<const uint4*>(words + (first + 2 * t) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = buf[4 * t + i];
      }
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[4 * i + 0] = v[i].x;
        w[4 * i + 1] = v[i].y;
        w[4 * i + 2] = v[i].z;
        w[4 * i + 3] = v[i].w;
      }
      hash_pair(w, st);
    }
  }
  if (live) {
    uint4* o = reinterpret_cast<uint4*>(out + ((first >> levels) + t) * 8);
    o[0] = make_uint4(st[0], st[1], st[2], st[3]);
    o[1] = make_uint4(st[4], st[5], st[6], st[7]);
  }
}

}  // namespace

extern "C" {

// data:     batch rows of row_bytes each (uint8, or host-order uint32 with
//           the same bytes), 16-byte aligned, row_bytes a multiple of 64
// nblocks:  int32[batch], clamped to [0, row_bytes / 64]
// out:      uint32[batch, 8], big-endian state words
// stream:   cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 = launched).
int tt_sha256_launch(const void* data, int64_t row_bytes, const void* nblocks,
                     void* out, int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 64 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (batch + kRowThreads - 1) / kRowThreads;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  sha256_rows_kernel<<<static_cast<unsigned>(grid), kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), row_bytes,
      static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}

// words:    uint32[nodes, 8] big-endian node words, 16-byte aligned
// out:      uint32[nodes >> levels, 8], 16-byte aligned: each run of
//           2^levels consecutive nodes reduced to its merkle root
// nodes:    a multiple of 2^levels
// levels:   1 ... tt_sha256_merkle_cap()
// stream:   cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 = launched).
int tt_sha256_merkle_launch(const void* words, void* out, int64_t nodes, int levels,
                            void* stream) {
  if (levels < 1 || levels > kMerkleCap || nodes < 0 || nodes % (int64_t{1} << levels) != 0 ||
      reinterpret_cast<uintptr_t>(words) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nodes == 0) return 0;
  const int64_t grid = (nodes + kMerkleSpan - 1) / kMerkleSpan;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  sha256_merkle_kernel<<<static_cast<unsigned>(grid), kMerkleThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), nodes, levels);
  return static_cast<int>(cudaGetLastError());
}

// The most levels one tt_sha256_merkle_launch reduces.
int tt_sha256_merkle_cap(void) { return kMerkleCap; }

// Threads (rows) a block of the rows kernel: the TT_SHA256_ROW_THREADS it
// was built with.
int tt_sha256_row_threads(void) { return kRowThreads; }

}  // extern "C"
