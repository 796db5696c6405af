// tile_rank.cuh: the stable rank of each digit within one tile, and the
// tile's histogram, computed by one thread block. Shared by the standalone
// counting kernel (hist_rank.cu) and the one-sweep radix pass
// (radix_onesweep.cu).
//
// Layout. A block of kWarps warps ranks a tile of kWarps * 32 * kItems
// digits. Warp w owns the contiguous run [w * 32 * kItems, (w + 1) * 32 *
// kItems) of the tile and walks it 32 digits at a time, in order: step s of
// lane l holds tile position w * 32 * kItems + s * 32 + l, so every load of
// a step is one coalesced line.
//
// Rank. In each step __match_any_sync gives the lanes that hold the same
// digit; the popcount of the peers below a lane is its rank within the step.
// The lowest peer adds the number of peers to the warp's running count of
// that digit, kept in shared memory, with one atomic that returns the count
// before it, and a shuffle hands that count to the peers: it lifts their
// ranks to ranks within the warp's run. The next step's atomic on the same
// count starts only after this shuffle has its value, so every count is
// exact and the ranks follow the order of the positions. After a barrier an
// exclusive scan over the warps of each bin turns the warps' counts into
// warp offsets (their total is the tile's count of the bin), and each digit
// adds its warp's offset. The result is the number of equal digits at
// earlier positions of the tile: exact and stable by order, the same on
// every run.

#pragma once

#include <stdint.h>

namespace tile_rank {

constexpr int kBins = 256;

// Shared memory that rank() works in: the warps' running counts per bin.
template <int kWarps>
struct Counts {
    int32_t warp[kWarps][kBins];
};

// Ranks the kItems digits this thread holds: digit_of(s) < nbins <= kBins
// is the digit at tile position warp * 32 * kItems + s * 32 + lane (a
// function, so that a caller may derive it from a key it keeps anyway
// instead of holding kItems more registers). On return ranks[s] is the
// stable rank of digit s within the tile, and total[b] (shared memory,
// nbins entries) is the tile's count of digit b. Every thread of the block
// must call it; it begins and ends with a barrier, so the caller may reuse
// `counts` and read `total` right after.
template <int kWarps, int kItems, typename DigitOf>
__device__ __forceinline__ void rank(DigitOf digit_of, int (&ranks)[kItems],
                                     Counts<kWarps>& counts,
                                     int32_t* total, int nbins)
{
    constexpr int kThreads = kWarps * 32;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;

    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
        counts.warp[i / kBins][i % kBins] = 0;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        const int d = digit_of(s);
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int before = __popc(peers & below);
        const int leader = __ffs(peers) - 1;
        int old = 0;
        if (lane == leader) {
            old = atomicAdd(&counts.warp[warp][d], __popc(peers));
        }
        ranks[s] = __shfl_sync(0xffffffffu, old, leader) + before;
    }
    __syncthreads();

    for (int b = threadIdx.x; b < nbins; b += kThreads) {
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int c = counts.warp[w][b];
            counts.warp[w][b] = acc;
            acc += c;
        }
        total[b] = acc;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        ranks[s] += counts.warp[warp][digit_of(s)];
    }
    __syncthreads();
}

}  // namespace tile_rank
