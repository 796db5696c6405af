// hist_rank: the counting step of one stable LSD radix pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel ytsaurus_tpu/ops/pallas_radix.py::_hist_rank_kernel
// (launched by hist_rank there). For each tile of 2048 int32 digits, with
// values below 2^bits (bits <= 8), it writes
//   counts[t, b] = how many digits of tile t equal b, and
//   rank[i]      = how many digits equal to digits[i] come before i in its tile,
// so that the caller can place element i at
//   bin_start[d] + (digits d in earlier tiles) + rank[i].
//
// What bounds it: memory. It reads 4 B and writes 4 B per element, plus
// 2^bits * 4 B of counts per tile: 8 B of traffic against a few dozen integer
// instructions per element. At N = 67,108,864 and 6 bits that is about 545 MB,
// or about 0.16 ms at the H100's 3.35 TB/s.
//
// Design, simple first. One block of 256 threads (8 warps) per tile. Warp w
// owns the 256 elements [256w, 256w + 256) of the tile and walks them 32 at a
// time, in order, so every load is one coalesced 128-byte line. In each step
// __match_any_sync gives the lanes that hold the same digit, the popcount of
// the peers below a lane gives its rank within the step, and the warp's
// running count for that digit, kept in shared memory, lifts it to a rank
// within the warp; the lowest peer then adds the number of peers to that
// count. After a barrier, an exclusive scan over the 8 warps of each bin turns
// the warp counts into warp offsets (their total is the tile's counts row),
// and each element adds its warp's offset to its rank. The whole state is
// 8 x 256 ints of shared memory, so many blocks fit on each SM and the loads
// of one block overlap the scan of another. Nothing here is tuned: a one-sweep
// design with a decoupled look-back would also fold the caller's scatter in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = kTile / kWarps;   // 256
constexpr int kSteps = kPerWarp / 32;      // 8
constexpr int kMaxBins = 256;

__global__ void __launch_bounds__(kThreads)
hist_rank_kernel(const int32_t* __restrict__ digits,
                 int32_t* __restrict__ counts,
                 int32_t* __restrict__ rank,
                 int nbins)
{
    __shared__ int32_t warp_count[kWarps][kMaxBins];

    const int64_t tile = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads) {
        warp_count[i / kMaxBins][i % kMaxBins] = 0;
    }
    __syncthreads();

    const int64_t base = tile * kTile + warp * kPerWarp;
    const unsigned below = (1u << lane) - 1u;
    // Digits are below nbins by contract; the mask only keeps a bad
    // input inside shared memory.
    const int digit_mask = nbins - 1;
    int digit[kSteps];
    int local_rank[kSteps];

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
        const int d = digits[base + s * 32 + lane] & digit_mask;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int before = __popc(peers & below);
        const int running = warp_count[warp][d];
        __syncwarp();
        if (before == 0) {
            warp_count[warp][d] = running + __popc(peers);
        }
        __syncwarp();
        digit[s] = d;
        local_rank[s] = running + before;
    }
    __syncthreads();

    for (int b = threadIdx.x; b < nbins; b += kThreads) {
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int c = warp_count[w][b];
            warp_count[w][b] = acc;
            acc += c;
        }
        counts[tile * nbins + b] = acc;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
        rank[base + s * 32 + lane] = local_rank[s] + warp_count[warp][digit[s]];
    }
}

}  // namespace

// digits: n int32 on the device, n % 2048 == 0, values < 2^bits.
// counts: (n / 2048, 2^bits) int32; rank: n int32. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int hist_rank_launch(const void* digits, void* counts, void* rank,
                                long long n, int bits, void* stream)
{
    if (n < 0 || n % kTile != 0 || bits < 1 || bits > 8) {
        return (int)cudaErrorInvalidValue;
    }
    const long long tiles = n / kTile;
    if (tiles == 0) {
        return 0;
    }
    if (tiles > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    hist_rank_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(digits), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(rank), 1 << bits);
    return (int)cudaGetLastError();
}
