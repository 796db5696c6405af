// dense_reduce: every reduction of a dense GROUP BY stage over at most 16
// segments, in one pass over the rows and a fold, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package reduces a dense group stage with
// XLA's fused reductions. The port's plain version
// (ops/segments.py::_dense_segment_reduce, one masked full-plane reduction
// per segment per aggregate) launched three kernels per segment per
// reduction, about 740 a stage for TPC-H Q1; this pass launches two for the
// whole stage.
//
// For segment ids seg (n int64; an id outside [0, nseg) belongs to no
// segment) and up to kMaxJobs jobs, each a plane of n values (or one value
// broadcast to every row) with a validity plane of n bytes (or one), it
// writes
//   out[j][s] = the job's reduction over the valid rows r with seg[r] == s,
// starting from the job's init (the reduction's neutral value): a wrapping
// int64 sum, a float64 sum, an int64 or float64 min or max (float min and
// max propagate NaN, as torch.amin and torch.amax do), or the count of
// valid rows. Values travel as 64-bit patterns; the wrapper widens narrower
// planes to int64 or float64.
//
// What bounds it: memory. Each plane is read once: 8 B of segment id a row,
// 8 B a value plane and 1 B a validity plane (TPC-H Q1's shard: 7 value and
// 8 validity planes, 72 B a row, 0.16 ms for 7.5M rows at 3.35 TB/s).
//
// Design:
//   1. The rows split into one contiguous range a block, over at most
//      kMaxBlocks blocks: whole units of 256 rows, as evenly as they go
//      (the first blocks take one unit more), so that no block is left
//      without rows. A block
//      walks its range in chunks of kChunk rows and keeps the chunk's
//      segment ids in shared memory, one byte a row, read once for all
//      the jobs.
//   2. For each job, each thread folds its rows of the chunk, kBatch loads
//      in flight at a time, into its own column of a shared-memory table
//      acc[segment][thread]: a row touches only its own segment's slot, so
//      a row costs a load and a store, whatever the number of segments.
//   3. The 256 columns of each segment fold in a fixed tree (16 partial
//      results a segment, then a shuffle across 16 lanes) into the block's
//      running result, which stays in shared memory across its chunks.
//   4. Each block writes its results; dense_reduce_fold folds, for each
//      job and segment, the blocks' results in a fixed tree (a warp, its
//      lanes over the blocks in order, then a shuffle).
// Nothing is added with atomics, the grid is a function of n alone, and
// every fold has a fixed order, so two runs give the same bits. A float
// sum adds in another order than the plain version, so it agrees with it to
// a relative tolerance, not bit for bit; integer results are exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;                    // rows a thread a chunk
constexpr int kBatch = 8;                     // loads in flight a thread
constexpr long long kChunk = (long long)kThreads * kItems;
constexpr int kSegments = 16;                 // ops/segments.py's limit
constexpr int kMaxJobs = 64;
// The grid's cap: four blocks an SM of the H100 SXM (132 SMs). A constant,
// not read from the device, so that the order of every sum depends on n
// alone.
constexpr int kMaxBlocks = 4 * 132;
constexpr int kFoldThreads = 32 * kSegments;  // a warp a segment
constexpr uint8_t kNoSegment = 0xFF;

enum Op : int {
    kCount = 0,
    kSumInt = 1,
    kSumFloat = 2,
    kMinInt = 3,
    kMaxInt = 4,
    kMinFloat = 5,
    kMaxFloat = 6,
};
constexpr int kOps = 7;

struct Job {
    const long long* data;        // null for kCount
    const uint8_t* valid;
    long long init;               // the neutral value's bit pattern
    int op;
    int data_stride;              // 1, or 0 for one broadcast value
    int valid_stride;             // the same for the validity plane
};

struct Jobs {
    Job job[kMaxJobs];
    int count;
};

template <int kOp>
__device__ __forceinline__ long long combine(long long a, long long b)
{
    if (kOp == kCount || kOp == kSumInt) {
        return (long long)((unsigned long long)a + (unsigned long long)b);
    } else if (kOp == kSumFloat) {
        return __double_as_longlong(__longlong_as_double(a) +
                                    __longlong_as_double(b));
    } else if (kOp == kMinInt) {
        return b < a ? b : a;
    } else if (kOp == kMaxInt) {
        return b > a ? b : a;
    } else {
        const double x = __longlong_as_double(a);
        const double y = __longlong_as_double(b);
        if (isnan(x)) {
            return a;
        }
        if (isnan(y)) {
            return b;
        }
        if (kOp == kMinFloat) {
            return y < x ? b : a;
        }
        return y > x ? b : a;
    }
}

// Calls f(std::integral_constant<int, op>()) for a run-time op.
template <typename F>
__device__ __forceinline__ void with_op(int op, F&& f)
{
    switch (op) {
    case kCount: f(std::integral_constant<int, kCount>()); break;
    case kSumInt: f(std::integral_constant<int, kSumInt>()); break;
    case kSumFloat: f(std::integral_constant<int, kSumFloat>()); break;
    case kMinInt: f(std::integral_constant<int, kMinInt>()); break;
    case kMaxInt: f(std::integral_constant<int, kMaxInt>()); break;
    case kMinFloat: f(std::integral_constant<int, kMinFloat>()); break;
    default: f(std::integral_constant<int, kMaxFloat>()); break;
    }
}

// One job over one chunk of rows base + i * kThreads + t (i < kItems),
// whose segments are seg[i][t]: they fold into block_acc[0 .. kSegments).
template <int kOp>
__device__ __forceinline__ void reduce_chunk(
    const Job& job, const uint8_t (*seg)[kThreads], long long base,
    long long (*acc)[kThreads], long long* block_acc)
{
    const int t = threadIdx.x;
#pragma unroll
    for (int s = 0; s < kSegments; ++s) {
        acc[s][t] = job.init;
    }
#pragma unroll 1
    for (int b = 0; b < kItems; b += kBatch) {
        long long value[kBatch];
        uint32_t live = 0;
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            const long long r = base + (long long)(b + i) * kThreads + t;
            const bool in = seg[b + i][t] != kNoSegment;
            const bool ok = in && job.valid[r * job.valid_stride] != 0;
            live |= (uint32_t)ok << i;
            value[i] = (kOp == kCount || !in) ? 1
                                              : job.data[r * job.data_stride];
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            if (live & (1u << i)) {
                const int s = seg[b + i][t];
                acc[s][t] = combine<kOp>(acc[s][t], value[i]);
            }
        }
    }
    __syncthreads();
    // Thread t folds columns l, l + 16, ... of segment t / 16 (l = t % 16),
    // then the 16 lanes of the segment fold in a fixed tree.
    const int s = t >> 4;
    const int l = t & 15;
    long long a = acc[s][l];
#pragma unroll
    for (int k = 1; k < kThreads / 16; ++k) {
        a = combine<kOp>(a, acc[s][l + 16 * k]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
        a = combine<kOp>(a, __shfl_down_sync(0xffffffffu, a, off, 16));
    }
    if (l == 0) {
        block_acc[s] = combine<kOp>(block_acc[s], a);
    }
    __syncthreads();
}

// The rows [lo, hi) of this block: n in whole units of kThreads rows,
// `units` units a block and one more for each of the first `extra`
// blocks (the launcher divides, so the kernel does not).
__device__ __forceinline__ void block_rows(long long n, long long units,
                                           int extra, long long* lo,
                                           long long* hi)
{
    const long long b = blockIdx.x;
    const long long first = b * units + (b < extra ? b : extra);
    const long long end = (first + units + (b < extra ? 1 : 0)) * kThreads;
    *lo = first * kThreads;
    *hi = end < n ? end : n;
}

// partial[(j * 16 + s) * gridDim.x + block]: the block's result of job j
// over segment s.
__global__ void __launch_bounds__(kThreads, 4)
dense_reduce_kernel(const __grid_constant__ Jobs jobs,
                    const int64_t* __restrict__ seg_ids, long long n,
                    int nseg, long long* __restrict__ partial,
                    long long units, int extra)
{
    __shared__ long long acc[kSegments][kThreads];
    __shared__ long long block_acc[kMaxJobs][kSegments];
    __shared__ uint8_t seg[kItems][kThreads];
    const int t = threadIdx.x;
    for (int i = t; i < jobs.count * kSegments; i += kThreads) {
        block_acc[i / kSegments][i % kSegments] = jobs.job[i / kSegments].init;
    }
    __syncthreads();

    long long lo, hi;
    block_rows(n, units, extra, &lo, &hi);
    for (long long base = lo; base < hi; base += kChunk) {
#pragma unroll 4
        for (int i = 0; i < kItems; ++i) {
            const long long r = base + (long long)i * kThreads + t;
            const long long id = r < hi ? seg_ids[r] : -1;
            seg[i][t] = (id >= 0 && id < nseg) ? (uint8_t)id : kNoSegment;
        }
        // A thread reads back only the ids it wrote: no barrier.
        for (int j = 0; j < jobs.count; ++j) {
            const Job& job = jobs.job[j];
            with_op(job.op, [&](auto op) {
                reduce_chunk<decltype(op)::value>(job, seg, base, acc,
                                                  block_acc[j]);
            });
        }
    }
    // reduce_chunk's last barrier (or the one above) orders block_acc.
    for (int i = t; i < jobs.count * kSegments; i += kThreads) {
        partial[(long long)i * gridDim.x + blockIdx.x] =
            block_acc[i / kSegments][i % kSegments];
    }
}

// Block j folds job j: warp s takes segment s, lane l the blocks l, l + 32,
// ... in order, then the 32 lanes fold in a fixed tree.
__global__ void __launch_bounds__(kFoldThreads)
dense_reduce_fold(const __grid_constant__ Jobs jobs,
                  const long long* __restrict__ partial, int blocks,
                  int nseg, long long* __restrict__ out, int out_stride)
{
    const int j = blockIdx.x;
    const int s = threadIdx.x / 32;
    const int l = threadIdx.x % 32;
    if (s >= nseg) {
        return;
    }
    const Job& job = jobs.job[j];
    const long long* p = partial + (long long)(j * kSegments + s) * blocks;
    with_op(job.op, [&](auto op) {
        constexpr int kOp = decltype(op)::value;
        long long a = job.init;
        for (int b = l; b < blocks; b += 32) {
            a = combine<kOp>(a, p[b]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a = combine<kOp>(a, __shfl_down_sync(0xffffffffu, a, off));
        }
        if (l == 0) {
            out[(long long)j * out_stride + s] = a;
        }
    });
}

// A chunk a block up to kMaxBlocks, and one block at n = 0, which writes
// the neutral values: every launch runs both kernels.
int blocks_for(long long n)
{
    const long long chunks = (n + kChunk - 1) / kChunk;
    return (int)(chunks < 1 ? 1 : chunks < kMaxBlocks ? chunks : kMaxBlocks);
}

}  // namespace

// The blocks of dense_reduce_kernel for n rows: the partials buffer holds
// blocks * count * 16 int64.
extern "C" int dense_reduce_blocks(long long n)
{
    return blocks_for(n);
}

// count jobs, each given by data[j] (a device pointer, 0 for a count),
// valid[j], init[j], op[j] and stride[j] (bit 0: the data plane has n rows,
// else one; bit 1: the same for validity). seg: n int64 on the device;
// partial: dense_reduce_blocks(n) * count * 16 int64; out: count rows of
// out_stride (>= nseg) int64, of which the first nseg are written. Launches
// both kernels on `stream`, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int dense_reduce_launch(int count, const long long* data,
                                   const long long* valid,
                                   const long long* init, const int* op,
                                   const int* stride, const void* seg,
                                   long long n, int nseg, void* partial,
                                   void* out, int out_stride, void* stream)
{
    if (count < 1 || count > kMaxJobs || nseg < 1 || nseg > kSegments ||
        out_stride < nseg || n < 0) {
        return (int)cudaErrorInvalidValue;
    }
    Jobs jobs = {};
    jobs.count = count;
    for (int j = 0; j < count; ++j) {
        if (op[j] < 0 || op[j] >= kOps ||
            (((op[j] != kCount && !data[j]) || !valid[j]) && n > 0)) {
            return (int)cudaErrorInvalidValue;
        }
        jobs.job[j].data = reinterpret_cast<const long long*>(data[j]);
        jobs.job[j].valid = reinterpret_cast<const uint8_t*>(valid[j]);
        jobs.job[j].init = init[j];
        jobs.job[j].op = op[j];
        jobs.job[j].data_stride = stride[j] & 1;
        jobs.job[j].valid_stride = (stride[j] >> 1) & 1;
    }
    const int blocks = blocks_for(n);
    const long long units = (n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    dense_reduce_kernel<<<blocks, kThreads, 0, s>>>(
        jobs, static_cast<const int64_t*>(seg), n, nseg,
        static_cast<long long*>(partial), units / blocks,
        (int)(units % blocks));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return (int)err;
    }
    dense_reduce_fold<<<count, kFoldThreads, 0, s>>>(
        jobs, static_cast<const long long*>(partial), blocks, nseg,
        static_cast<long long*>(out), out_stride);
    return (int)cudaGetLastError();
}
