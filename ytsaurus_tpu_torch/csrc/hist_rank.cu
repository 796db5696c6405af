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
// Design. One block of 256 threads (8 warps) per tile; the rank and the
// histogram come from tile_rank::rank (tile_rank.cuh), the same device code
// that ranks each tile inside the one-sweep radix pass (radix_onesweep.cu).
// Warp w owns the 256 elements [256w, 256w + 256) of the tile and walks them
// 32 at a time, so every load is one coalesced 128-byte line. The whole state
// is 9 x 256 ints of shared memory, so many blocks fit on each SM and the
// loads of one block overlap the scan of another. This kernel keeps the
// Pallas kernel's interface and leaves the scan across tiles and the scatter
// to its caller; radix_onesweep.cu folds both into the pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_rank.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kItems = kTile / kThreads;   // 8 digits per thread

__global__ void __launch_bounds__(kThreads)
hist_rank_kernel(const int32_t* __restrict__ digits,
                 int32_t* __restrict__ counts,
                 int32_t* __restrict__ rank,
                 int nbins)
{
    __shared__ tile_rank::Counts<kWarps> warp_counts;
    __shared__ int32_t total[tile_rank::kBins];

    const int64_t tile = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t base = tile * kTile + warp * (32 * kItems) + lane;
    // Digits are below nbins by contract; the mask only keeps a bad
    // input inside shared memory.
    const int digit_mask = nbins - 1;
    int digit[kItems];
    int local_rank[kItems];
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        digit[s] = digits[base + s * 32] & digit_mask;
    }
    tile_rank::rank<kWarps, kItems>([&](int s) { return digit[s]; },
                                    local_rank, warp_counts, total, nbins);
    for (int b = threadIdx.x; b < nbins; b += kThreads) {
        counts[tile * nbins + b] = total[b];
    }
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
        rank[base + s * 32] = local_rank[s];
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
