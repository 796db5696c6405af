// radix_upsweep: one read of a u32 sort word that writes its int32 key plane
// and counts every 8-bit digit of it, for Hopper (sm_90a).
//
// With radix_onesweep.cu it replaces the TPU kernel
// ytsaurus_tpu/ops/pallas_radix.py::_hist_rank_kernel together with its
// caller radix_pass_pallas: the Pallas route gathers each pass's digits
// through the permutation and scatters the permutation after a counting
// kernel; here each key word is gathered once, and the passes over it move
// keys and row indices together.
//
// For a word of n u32 values (held in int64, as torch has no uint32
// arithmetic on the CPU) and a permutation perm of int32 row indices (or
// none, for the first word of a sort) it writes
//   key[i]         = low 32 bits of word[perm[i]] (word[i] without perm),
//                    as an int32 bit pattern, and
//   hist[p][b]    += how many i have digit p of key[i] equal to b,
// for the digit positions p < positions (<= 4). hist must be zero before the
// launch.
//
// What bounds it: memory. The first word reads 8 B and writes 4 B per
// element; a later one reads 4 B of perm and 8 B of word and writes 4 B
// (0.24 ms and 0.32 ms at N = 67,108,864 and 3.35 TB/s). The gather through
// perm touches a 32-byte sector for each 8-byte value, so a later word moves
// about twice its bound's bytes.
//
// Design. A grid of a few blocks per SM walks the elements in steps of
// 32 * kUnroll per warp, with kUnroll loads in flight per thread (the
// gather through perm is bound by latency, not by bytes). Each block
// counts into a shared-memory histogram per position, then adds each
// nonzero bin to the global table with one atomic: integer counts
// are exact in any order. A step whose 32 lanes hold one digit (a constant
// digit, common in packed keys) adds 32 with one shared atomic instead of 32
// colliding ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kMaxPositions = 4;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 2;

__global__ void __launch_bounds__(kThreads)
radix_upsweep_kernel(const int64_t* __restrict__ word,
                     const int32_t* __restrict__ perm,
                     int32_t* __restrict__ key,
                     int32_t* __restrict__ hist,
                     long long n, int positions)
{
    __shared__ int32_t count[kMaxPositions][kBins];
    for (int i = threadIdx.x; i < kMaxPositions * kBins; i += kThreads) {
        count[i / kBins][i % kBins] = 0;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * kThreads * kUnroll;
    // A warp takes 32 * kUnroll consecutive elements a step, lane l the
    // elements l, l + 32, ...: kUnroll independent loads (and, through
    // perm, kUnroll independent gathers) in flight per thread. The loop
    // bound is the same for the 32 lanes of a warp, so the warp votes below
    // see every lane.
    for (long long base = ((long long)blockIdx.x * kThreads +
                           (threadIdx.x & ~31)) * kUnroll;
         base < n; base += stride) {
        uint32_t u[kUnroll];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
            const long long i = base + r * 32 + lane;
            u[r] = i < n ? (uint32_t)(perm ? word[perm[i]] : word[i]) : 0u;
        }
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
            const long long i = base + r * 32 + lane;
            const bool valid = i < n;
            if (valid) {
                key[i] = (int32_t)u[r];
            }
            for (int p = 0; p < positions; ++p) {
                const int d = (int)((u[r] >> (8 * p)) & 0xFFu);
                const int d0 = __shfl_sync(0xffffffffu, d, 0);
                if (__all_sync(0xffffffffu, valid && d == d0)) {
                    if (lane == 0) {
                        atomicAdd(&count[p][d], 32);
                    }
                } else if (valid) {
                    atomicAdd(&count[p][d], 1);
                }
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < positions * kBins; i += kThreads) {
        const int c = count[i / kBins][i % kBins];
        if (c) {
            atomicAdd(&hist[i], c);
        }
    }
}

}  // namespace

// word: n int64 on the device (values in [0, 2^32)); perm: n int32 or null;
// key: n int32; hist: (positions, 256) int32, zeroed. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int radix_upsweep_launch(const void* word, const void* perm,
                                    void* key, void* hist, long long n,
                                    int positions, void* stream)
{
    if (n < 0 || positions < 1 || positions > kMaxPositions) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) {
        return 0;
    }
    int device = 0;
    int sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long needed = (n + kThreads * kUnroll - 1) /
                             (kThreads * kUnroll);
    const long long most = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
    const unsigned blocks = (unsigned)(needed < most ? needed : most);
    radix_upsweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int64_t*>(word), static_cast<const int32_t*>(perm),
        static_cast<int32_t*>(key), static_cast<int32_t*>(hist), n,
        positions);
    return (int)cudaGetLastError();
}
