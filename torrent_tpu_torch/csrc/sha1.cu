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
// Here a loop over blocks replaces the serial grid axis, one lane of one
// warp owns each piece's state for the whole chain, and the message
// schedule is computed by other warps of the same CTA.
//
// What bounds it on an H100. Per 64-byte block SHA-1 needs 613 integer
// instructions (ops/work.py SHA1_BLOCK_OPS: 16 byteswaps, 64 x 3 for
// the schedule, 80 x 5 for the rounds, 5 for the feed-forward) against 64
// bytes of input: integer-ALU work, not memory traffic. Within a piece
// the 80 rounds of every block form one serial chain, so the batch is the
// only parallelism. Up to 132 x 32 = 4,224 rows (the v1 recheck's 4096,
// authoring's 256) there is at most one warp of pieces per SM, and the
// launch takes as long as ONE piece's chain: the batch's total work never
// enters. Beyond that the card's integer rate bounds it.
//
// The first design gave each piece one thread that also loaded its blocks
// and computed their schedule: its warp issued all 613 instructions of a
// block, at two cycles each on a scheduler's 16 INT32 lanes, with no
// other warp to hide the stalls (measured ~1,850 cycles a block). This
// design takes everything off the chain's warp that does not have to be
// on it:
//
//   - One CTA per 32 pieces, three warps. Warp 0 is the round warp: one
//     lane per piece, a..e and the chaining state in registers; it runs
//     only the 80 rounds and the feed-forward. Warps 1 and 2 are the
//     schedule warps: warp 1 takes the even blocks, warp 2 the odd ones.
//     The warps of a CTA are spread over the SM's schedulers, so at one
//     CTA per SM the round warp's scheduler has little else to issue.
//   - Loads: each schedule-warp lane moves its piece's blocks into its
//     64-byte slot of a 3-stage raw ring in shared memory with four
//     16-byte cp.async (LDGSTS) a block, one commit group per block, so
//     three blocks are in flight while it computes; cp.async.wait_group
//     tells the lane when its oldest has landed. A lane reads back only
//     its own bytes, so the raw ring needs no cross-lane ordering (the
//     64-byte stride costs a 4-way bank conflict on 4 LDS.128 a block).
//     Not cp.async.bulk: it takes its addresses in uniform registers, so
//     32 lanes with 32 sources compile into a 32-trip loop (ELECT, R2UR,
//     UBLKCP) of ~290 instructions a block, which slowed the schedule
//     warps below the round warp (measured: 1,382 cycles a block at 32
//     pieces a CTA, against 866 with one).
//   - The schedule warp byteswaps the 16 words, expands W[16..79] and adds
//     K_t, and writes the 80 words W_t + K_t to a 4-stage ring laid out
//     [stage][t/4][piece][4]: the round warp's 32 lanes read 32
//     consecutive 16-byte words (20 LDS.128 a block, no bank conflict).
//     Full and empty mbarriers per stage order the ring; block j uses
//     stage j % 4, so each stage has a single producer.
//   - The round body folds f + e + (W + K) off the dependent path. ptxas
//     fuses rotl(a, 5) + (f + e + W + K) into one LEA.HI, so a round is
//     four ALU-pipe instructions: LOP3 (f), IADD3 (f + e + W + K), LEA.HI
//     and SHF (rotl(b, 30)); no add goes to the FMA pipe.
//
// The SASS (sm_90a): the round warp's loop is 374 instructions a block,
// 364 of them on the path taken when the ring is ready (320 round
// instructions, 20 LDS.128, the wait, the arrive, the keep-masked
// feed-forward), against 628 in the first design's loop; each schedule
// warp's loop is 362 a block. Measured on an H100 (chip_smoke.py): ~880
// cycles a block whether a CTA holds 1 piece or 32, so the round warp is
// held by its dependent chain (f from the round before last, the add,
// the LEA.HI: ~11 cycles a round), not by ALU issue. Moving the two adds
// to the FMA pipe (IMAD by an opaque 1) left three ALU instructions a
// round and made 4096 rows 3% slower and 16384 rows 12% faster; the
// main path's batches are chain-bound, so the adds stay IADD3.
//
// Ragged chains. A CTA's pieces have different nblocks: the rings run to
// the CTA's largest count, a lane keeps its state only while blk < n (the
// reference's keep mask), and no copy is issued past a piece's own count
// (lanes past it compute on stale ring words, which are never kept).
//
// Shared memory: 4 x 10 KiB (W+K) + 2 x 3 x 2 KiB (raw) + 8 mbarriers +
// 32 counts = 53,440 bytes, dynamic (over the 48 KiB static limit), so
// four CTAs fit an SM at 16384 rows. A ring wait that has not completed
// after kWaitLimitNs traps, so a fault in the ring's ordering ends the
// launch with an error instead of hanging the card.
//
// Row offsets are 64-bit: 4096 rows of 1 MiB pieces span 4.3 GB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The launch design's three knobs are compile-time parameters, so that
// torrent_tpu_torch/tools/tune_sha1.py can build variants with -D flags
// (ops/sha1_cuda.py::load_variant). The defaults are the production
// kernel's; the static_asserts below hold every variant.
#ifndef TT_SHA1_SCHEDULE_WARPS
#define TT_SHA1_SCHEDULE_WARPS 2
#endif
#ifndef TT_SHA1_WK_STAGES
#define TT_SHA1_WK_STAGES 4
#endif
#ifndef TT_SHA1_RAW_STAGES
#define TT_SHA1_RAW_STAGES 3
#endif

constexpr int kPieces = 32;             // pieces per CTA, one lane each
constexpr int kScheduleWarps = TT_SHA1_SCHEDULE_WARPS;  // block j: schedule warp j % this
constexpr int kThreads = 32 * (1 + kScheduleWarps);
constexpr int kWkStages = TT_SHA1_WK_STAGES;    // W+K ring: block j in stage j % this
constexpr int kRawStages = TT_SHA1_RAW_STAGES;  // raw ring of each schedule warp
constexpr int kQuads = 20;              // 80 words as 20 uint4 per piece
constexpr int kWkStageBytes = kQuads * kPieces * 16;
constexpr int kRawStageBytes = kPieces * 64;
constexpr int kWkBytes = kWkStages * kWkStageBytes;
constexpr int kRawBytes = kScheduleWarps * kRawStages * kRawStageBytes;
constexpr int kBarriers = 2 * kWkStages;
constexpr int kSmemBytes = kWkBytes + kRawBytes + kBarriers * 8 + kPieces * 4;
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

static_assert(kScheduleWarps >= 1 && kWkStages >= 1 && kRawStages >= 1, "every ring needs a stage");
static_assert(kWkStages % kScheduleWarps == 0, "each W+K stage needs a single producer");
static_assert(kSmemBytes <= 232448, "over Hopper's 227 KB of shared memory per block");

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// Little-endian load of bytes b0 b1 b2 b3 -> big-endian word b0b1b2b3.
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t round_k(int t) {
  return t < 20 ? 0x5A827999u : t < 40 ? 0x6ED9EBA1u : t < 60 ? 0x8F1BBCDCu : 0xCA62C1D6u;
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// ------------------------------------------------------------ cp.async

// This lane's 64-byte block into its raw-ring slot, as four 16-byte copies.
__device__ __forceinline__ void fetch_block(uint4* dst, const uint8_t* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + i)),
                 "l"(src + 16 * i)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this lane's newest groups are in flight.
template <int pending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// ------------------------------------------------------------ the roles

__device__ __forceinline__ void sha1_round(int t, uint32_t& a, uint32_t& b, uint32_t& c,
                                           uint32_t& d, uint32_t& e, uint32_t wk) {
  uint32_t f;
  if (t < 20) {
    f = d ^ (b & (c ^ d));  // ch
  } else if (t < 40 || t >= 60) {
    f = b ^ c ^ d;
  } else {
    f = (b & c) | (d & (b ^ c));  // maj
  }
  // f, e and W + K are ready a round early: only rotl(a, 5) and the last
  // add wait on the previous round
  const uint32_t tmp = rotl(a, 5) + (f + e + wk);
  e = d;
  d = c;
  c = rotl(b, 30);
  b = a;
  a = tmp;
}

// Warp 0: the 80 rounds and the feed-forward of every block, W + K from
// the ring. It reads no device memory and computes no schedule.
__device__ __forceinline__ void round_warp(const uint4* wk, uint64_t* full, uint64_t* empty,
                                           int lane, int n, int nmax, int64_t row, int64_t batch,
                                           uint32_t* out) {
  uint32_t h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu, h3 = 0x10325476u,
           h4 = 0xC3D2E1F0u;
  for (int blk = 0; blk < nmax; ++blk) {
    const int s = blk % kWkStages;
    mbar_wait(full + s, (blk / kWkStages) & 1);
    const uint4* w = wk + s * (kQuads * kPieces) + lane;
    uint32_t a = h0, b = h1, c = h2, d = h3, e = h4;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const uint4 v = w[q * kPieces];
      sha1_round(4 * q + 0, a, b, c, d, e, v.x);
      sha1_round(4 * q + 1, a, b, c, d, e, v.y);
      sha1_round(4 * q + 2, a, b, c, d, e, v.z);
      sha1_round(4 * q + 3, a, b, c, d, e, v.w);
    }
    mbar_arrive(empty + s);
    if (blk < n) {
      h0 += a;
      h1 += b;
      h2 += c;
      h3 += d;
      h4 += e;
    }
  }
  if (row < batch) {
    uint32_t* o = out + row * 5;
    o[0] = h0;
    o[1] = h1;
    o[2] = h2;
    o[3] = h3;
    o[4] = h4;
  }
}

// Warps 1 and 2: schedule warp p takes blocks p, p + 2, p + 4, ... Each
// lane keeps kRawStages of its piece's blocks in flight through its raw
// ring, one cp.async group per block (empty past the piece's count, so
// every lane commits alike), and turns each block into 80 words
// W_t + K_t in the W+K ring.
__device__ __forceinline__ void schedule_warp(int p, const uint8_t* data, int64_t row_bytes,
                                              uint4* raw, uint4* wk, uint64_t* full,
                                              uint64_t* empty, int lane, int n, int nmax,
                                              int64_t row) {
  const uint8_t* src = data + row * row_bytes;  // dereferenced only for blocks < n
  uint4* mine = raw + lane * 4;                 // this lane's 64 bytes of stage 0
  constexpr int kStride = kScheduleWarps * kRawStages;  // blocks between refills of a stage
#pragma unroll
  for (int i = 0; i < kRawStages; ++i) {
    const int j = p + kScheduleWarps * i;
    if (j < n) fetch_block(mine + i * (kPieces * 4), src + int64_t(j) * 64);
    commit_group();
  }
  int r = 0;
  for (int j = p; j < nmax; j += kScheduleWarps) {
    uint4* stage = mine + r * (kPieces * 4);
    wait_group<kRawStages - 1>();  // this block's group, the oldest in flight
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = stage[i];
      w[4 * i + 0] = bswap(v.x);
      w[4 * i + 1] = bswap(v.y);
      w[4 * i + 2] = bswap(v.z);
      w[4 * i + 3] = bswap(v.w);
    }
    const int s = j % kWkStages;
    mbar_wait(empty + s, ((j / kWkStages) & 1) ^ 1);  // the first use passes at once
    uint4* dst = wk + s * (kQuads * kPieces) + lane;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * q + k;
        if (t >= 16) {
          // w[t-3] ^ w[t-8] ^ w[t-14] ^ w[t-16] on a 16-word rolling window
          w[t & 15] = rotl(w[(t + 13) & 15] ^ w[(t + 8) & 15] ^ w[(t + 2) & 15] ^ w[t & 15], 1);
        }
        v[k] = w[t & 15] + round_k(t);
      }
      dst[q * kPieces] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    mbar_arrive(full + s);
    // refill the raw stage: the stores above consumed every word read from it
    const int jn = j + kStride;
    if (jn < n) fetch_block(stage, src + int64_t(jn) * 64);
    commit_group();
    if (++r == kRawStages) r = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
sha1_rows_kernel(const uint8_t* __restrict__ data, int64_t row_bytes,
                 const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out,
                 int64_t batch) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint4* wk = reinterpret_cast<uint4*>(smem);
  uint4* raw = reinterpret_cast<uint4*>(smem + kWkBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWkBytes + kRawBytes);
  uint64_t* empty = full + kWkStages;
  int32_t* counts = reinterpret_cast<int32_t*>(full + kBarriers);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kPieces + lane;
  if (warp == 1) {
    int64_t n = 0;
    if (row < batch) {
      const int64_t max_blocks = row_bytes / 64;
      n = nblocks[row];
      n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
    }
    counts[lane] = static_cast<int32_t>(n);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWkStages; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n = counts[lane];
  const int nmax = __reduce_max_sync(0xFFFFFFFFu, n);
  if (warp == 0) {
    round_warp(wk, full, empty, lane, n, nmax, row, batch, out);
  } else {
    const int p = warp - 1;
    schedule_warp(p, data, row_bytes, raw + p * kRawStages * (kPieces * 4), wk, full, empty,
                  lane, n, nmax, row);
  }
}

// Allow the dynamic shared memory, and prefer shared memory to L1 (the
// kernel reads no device memory through L1 worth keeping), so four CTAs
// fit an SM at large batches. Per device, so done before every launch.
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(sha1_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(sha1_rows_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// data:     batch rows of row_bytes each (uint8, or host-order uint32 with
//           the same bytes), 16-byte aligned, row_bytes a multiple of 64
// nblocks:  int32[batch], clamped to [0, row_bytes / 64]
// out:      uint32[batch, 5], big-endian state words
// stream:   cudaStream_t to launch on
// Returns the first CUDA error of the shared-memory set-up or the launch
// (0 = launched).
int tt_sha1_launch(const void* data, int64_t row_bytes, const void* nblocks,
                   void* out, int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 64 != 0 ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (batch + kPieces - 1) / kPieces;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  sha1_rows_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), row_bytes,
      static_cast<const int32_t*>(nblocks), static_cast<uint32_t*>(out), batch);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one CTA, in bytes (ptxas reports only static).
int tt_sha1_smem_bytes() { return kSmemBytes; }

// CTAs of the kernel that fit one SM of the current device, or minus the
// CUDA error that prevented the answer.
int tt_sha1_ctas_per_sm() {
  cudaError_t err = configure();
  int ctas = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, sha1_rows_kernel, kThreads,
                                                        kSmemBytes);
  }
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

}  // extern "C"
