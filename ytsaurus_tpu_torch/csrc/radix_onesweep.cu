// radix_onesweep: one stable 8-bit LSD radix pass over (key, value) int32
// planes in a single launch, for Hopper (sm_90a).
//
// With radix_upsweep.cu it replaces the TPU kernel
// ytsaurus_tpu/ops/pallas_radix.py::_hist_rank_kernel together with its
// caller radix_pass_pallas (the counting kernel, the destination arithmetic
// and the permutation scatter of one pass). Given the exclusive start of
// every digit's run in the output (bin_start, from radix_upsweep's table),
// it writes key_out and val_out: the input pairs ordered stably by digit
// ((uint32)key >> shift) & 0xFF.
//
// What bounds it: memory. It reads and writes 4 B of key and 4 B of value
// per element, 16 B in all, or 0.32 ms at N = 67,108,864 and 3.35 TB/s; the
// look-back status adds 1 KB per tile.
//
// Design: a one-sweep pass with a decoupled look-back.
//   1. A block claims its tile with an atomic counter, not blockIdx.x: the
//      look-back waits only on tiles claimed earlier, which are held by
//      blocks already running, so it makes progress whatever order the
//      hardware starts blocks in.
//   2. It loads the tile's keys coalesced (a ragged last tile is masked
//      here, its missing digits ranked as 255 after every real one) and
//      ranks the digits with tile_rank::rank (tile_rank.cuh): the tile's
//      histogram and each element's stable rank within the tile. The
//      values load after the rank, so that only the keys and the ranks
//      hold registers through it.
//   3. Thread b owns digit b. It publishes the tile's count of b with an
//      "aggregate" flag, walks back over earlier tiles, adding aggregates
//      until it meets a "prefix" (the inclusive count of b over all tiles up
//      to that one), then publishes its own inclusive prefix. Flag (2 bits)
//      and count (30 bits) share one 32-bit word, stored and loaded whole,
//      so a reader never sees one without the other; n is below 2^30.
//   4. The block reorders its keys and values in shared memory by (digit,
//      rank), so that each digit's run leaves as one contiguous write at
//      bin_start + (the digit's count in earlier tiles) + offset.
// Order, not atomics, fixes every position, so the result is exact and the
// same on every run. The status array and the tile counter must be zero
// before each launch.
//
// Tile: 256 threads x 20 digits (5120 rows) a block, at most 85 registers a
// thread and 44 KB of shared memory, so three blocks share an SM. The
// wrapper's ITEMS picks it among the layouts 256 x {8, 12, 16, 20}, which
// chip_smoke.py times on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_rank.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBins = tile_rank::kBins;   // one digit per thread below
static_assert(kThreads == kBins, "thread b owns digit b");

constexpr uint32_t kFlagAggregate = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;

// The status word carries its own data (flag and count), and nothing else
// is read on the strength of it, so relaxed accesses at GPU scope suffice:
// a release store would add a memory barrier to every publication.
__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v)
{
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p)
{
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Exclusive sum of x over the block's threads, in thread order.
__device__ __forceinline__ int block_exclusive_sum(int x, int32_t* warp_sums)
{
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int inclusive = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inclusive, o);
        if (lane >= o) {
            inclusive += y;
        }
    }
    if (lane == 31) {
        warp_sums[warp] = inclusive;
    }
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) {
        before += warp_sums[w];
    }
    return before + inclusive - x;
}

// Three blocks of 256 threads per SM: at most 85 registers a thread.
template <int kItems>
__global__ void __launch_bounds__(kThreads, 3)
radix_onesweep_kernel(const int32_t* __restrict__ key_in,
                      const int32_t* __restrict__ val_in,
                      int32_t* __restrict__ key_out,
                      int32_t* __restrict__ val_out,
                      const int32_t* __restrict__ bin_start,
                      uint32_t* __restrict__ status,
                      int* __restrict__ tile_counter,
                      long long n, int shift)
{
    constexpr int kTile = kThreads * kItems;
    // The warps' counts are dead once tile_rank::rank returns (it ends with
    // a barrier), and the staged tile is written only after: one buffer.
    __shared__ union {
        tile_rank::Counts<kWarps> counts;
        struct {
            int32_t key[kTile];
            int32_t val[kTile];
        } stage;
    } sm;
    __shared__ int32_t total[kBins];
    __shared__ int32_t local_start[kBins];
    __shared__ int32_t dest_base[kBins];
    __shared__ int32_t warp_sums[kWarps];
    __shared__ int tile_shared;

    if (threadIdx.x == 0) {
        tile_shared = atomicAdd(tile_counter, 1);
    }
    __syncthreads();
    const int tile = tile_shared;
    const long long tile_base = (long long)tile * kTile;
    const int valid = (int)(n - tile_base < kTile ? n - tile_base : kTile);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int first = warp * (32 * kItems) + lane;
    // A masked slot of a ragged tile holds the all-ones key: digit 255,
    // ranked after every real one.
    int key[kItems];
    int rank[kItems];
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int pos = first + s * 32;
        key[s] = pos < valid ? key_in[tile_base + pos] : -1;
    }
    const auto digit_of = [&](int s) {
        return (int)(((uint32_t)key[s] >> shift) & 0xFFu);
    };
    tile_rank::rank<kWarps, kItems>(digit_of, rank, sm.counts, total, kBins);
    // The values are needed only for the reorder: load them now, so that
    // the loads are in flight during the look-back.
    int val[kItems];
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int pos = first + s * 32;
        val[s] = pos < valid ? val_in[tile_base + pos] : 0;
    }

    // Thread b: the look-back for digit b. The masked slots of a ragged
    // tile were counted as digit 255; they are not published.
    const int b = threadIdx.x;
    const int count = total[b] - (b == kBins - 1 ? kTile - valid : 0);
    uint32_t* mine = status + (long long)tile * kBins + b;
    int before = 0;
    if (tile == 0) {
        store_status(mine, kFlagPrefix | (uint32_t)count);
    } else {
        store_status(mine, kFlagAggregate | (uint32_t)count);
        for (long long t = tile - 1;; --t) {
            const uint32_t* theirs = status + t * kBins + b;
            uint32_t word;
            do {
                word = load_status(theirs);
            } while ((word & ~kCountMask) == 0);
            before += (int)(word & kCountMask);
            if (word & kFlagPrefix) {
                break;
            }
        }
        store_status(mine, kFlagPrefix | (uint32_t)(before + count));
    }
    const int start = block_exclusive_sum(count, warp_sums);
    local_start[b] = start;
    dest_base[b] = bin_start[b] + before - start;
    __syncthreads();

    // Reorder the tile by (digit, rank); masked slots land past `valid`.
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int pos = local_start[digit_of(s)] + rank[s];
        sm.stage.key[pos] = key[s];
        sm.stage.val[pos] = val[s];
    }
    __syncthreads();

    for (int j = threadIdx.x; j < valid; j += kThreads) {
        const int k = sm.stage.key[j];
        const int d = (int)(((uint32_t)k >> shift) & 0xFFu);
        const int dest = dest_base[d] + j;
        key_out[dest] = k;
        val_out[dest] = sm.stage.val[j];
    }
}

template <int kItems>
int launch(const void* key_in, const void* val_in, void* key_out,
           void* val_out, const void* bin_start, void* status, long long n,
           int shift, cudaStream_t stream)
{
    constexpr long long kTile = (long long)kThreads * kItems;
    const long long tiles = (n + kTile - 1) / kTile;
    uint32_t* words = static_cast<uint32_t*>(status);
    radix_onesweep_kernel<kItems><<<(unsigned)tiles, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(key_in),
        static_cast<const int32_t*>(val_in),
        static_cast<int32_t*>(key_out), static_cast<int32_t*>(val_out),
        static_cast<const int32_t*>(bin_start), words,
        reinterpret_cast<int*>(words + tiles * kBins), n, shift);
    return (int)cudaGetLastError();
}

}  // namespace

// key_in, val_in, key_out, val_out: n int32 on the device, n < 2^30;
// bin_start: 256 int32, the exclusive start of each digit's run;
// status: tiles * 256 + 1 zeroed int32 words, tiles = ceil(n / (256 *
// items)) (the last word is the tile counter). items, the digits each
// thread ranks, is 8, 12, 16 or 20. Launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// it does not take).
extern "C" int radix_onesweep_launch(const void* key_in, const void* val_in,
                                     void* key_out, void* val_out,
                                     const void* bin_start, void* status,
                                     long long n, int shift, int items,
                                     void* stream)
{
    if (n < 0 || n >= (1LL << 30) || shift < 0 || shift > 24) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) {
        return 0;
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (items) {
    case 8:
        return launch<8>(key_in, val_in, key_out, val_out, bin_start, status,
                         n, shift, s);
    case 12:
        return launch<12>(key_in, val_in, key_out, val_out, bin_start,
                          status, n, shift, s);
    case 16:
        return launch<16>(key_in, val_in, key_out, val_out, bin_start,
                          status, n, shift, s);
    case 20:
        return launch<20>(key_in, val_in, key_out, val_out, bin_start,
                          status, n, shift, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
