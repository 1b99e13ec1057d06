// Single-pass stream compaction helpers shared by K3 (voxel_reduce.cu) and
// K5 (compact.cu): the decoupled look-back of Merrill & Garland's
// single-pass prefix scan, and the launch that zeroes an output's rows at
// or past a count that only the device knows.
//
// Look-back.  The units of a call (a K3 warp's chunk of tiles, a K5
// block's 2048 rows) take their index from a ticket (an atomicAdd on the
// word after the status words), so every unit before one that is running
// has started and will publish.  A unit publishes its aggregate, looks
// back for its exclusive prefix, then publishes its inclusive prefix.  A
// status word is one 64-bit store: the flag in the top two bits, the value
// in the low 32, stored with release and loaded with acquire semantics.
// The status words and the ticket come from one torch.zeros of units + 1
// int64: flag 0 means "not yet published".
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PT_FULL_MASK 0xFFFFFFFFu
#define PT_FLAG_AGGREGATE (1ull << 62)
#define PT_FLAG_INCLUSIVE (2ull << 62)

__device__ __forceinline__ void pt_store_release(unsigned long long* p,
                                                 unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long pt_load_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ int pt_warp_sum(int v) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(PT_FULL_MASK, v, d);
    return v;
}

// Exclusive prefix of unit `unit` (> 0), by one whole warp: lane i reads
// the status of unit - 1 - i; the warp sums back to the nearest inclusive
// prefix, 32 units a round, and reads again while a unit on the way has
// not published.  Units before unit 0 count as an inclusive prefix of 0.
__device__ __forceinline__ int pt_look_back(
        const unsigned long long* status, long long unit, int lane) {
    int excl = 0;
    long long idx = unit - 1 - lane;
    while (true) {
        const unsigned long long s =
            idx >= 0 ? pt_load_acquire(status + idx) : PT_FLAG_INCLUSIVE;
        const unsigned flag = (unsigned)(s >> 62);
        const unsigned inc = __ballot_sync(PT_FULL_MASK, flag == 2u);
        const unsigned zero = __ballot_sync(PT_FULL_MASK, flag == 0u);
        // lanes up to and including the nearest inclusive prefix (all 32
        // when there is none)
        const unsigned need = inc ? ((inc & (0u - inc)) << 1) - 1u
                                  : PT_FULL_MASK;
        if (zero & need) continue;
        excl += pt_warp_sum(((need >> lane) & 1u) ? (int)(uint32_t)s : 0);
        if (inc) return excl;
        idx -= 32;
    }
}

// The publication of a unit: its aggregate (or at once its inclusive
// prefix, for unit 0), the look-back, the inclusive prefix; the last unit
// also writes the total to *count.  Called by a whole warp; returns the
// unit's exclusive prefix in every lane.
__device__ __forceinline__ int pt_publish_and_look_back(
        unsigned long long* status, long long unit, long long units,
        int aggregate, int* count, int lane) {
    if (lane == 0)
        pt_store_release(status + unit,
                         (unit == 0 ? PT_FLAG_INCLUSIVE : PT_FLAG_AGGREGATE)
                             | (uint32_t)aggregate);
    const int excl = unit == 0 ? 0 : pt_look_back(status, unit, lane);
    if (lane == 0) {
        if (unit > 0)
            pt_store_release(status + unit,
                             PT_FLAG_INCLUSIVE | (uint32_t)(excl + aggregate));
        if (unit == units - 1) *count = excl + aggregate;
    }
    return excl;
}

// ---- zero tail ---------------------------------------------------------------

#define PT_TAIL_MAX 8
#define PT_TAIL_THREADS 256
#define PT_TAIL_BLOCKS 264      // two a streaming multiprocessor

// A buffer's rows are row_bytes wide, pitch bytes apart (pitch ==
// row_bytes: the rows are contiguous).
struct PtTail {
    char* ptr[PT_TAIL_MAX];
    long long row_bytes[PT_TAIL_MAX];
    long long pitch[PT_TAIL_MAX];
};

// Zero bytes [lo, hi) of p by threads tid of stride: 16-byte stores between
// the unaligned head and tail bytes.
__device__ __forceinline__ void pt_zero_bytes(char* __restrict__ p,
                                              long long lo, long long hi,
                                              long long tid,
                                              long long stride) {
    const long long lead = (16 - ((uintptr_t)(p + lo) & 15)) & 15;
    const long long head = lead < hi - lo ? lead : hi - lo;
    if (tid < head) p[lo + tid] = 0;
    const long long vlo = lo + head;
    const long long nvec = (hi - vlo) >> 4;
    uint4* __restrict__ v = (uint4*)(p + vlo);
    for (long long i = tid; i < nvec; i += stride) v[i] = make_uint4(0, 0, 0, 0);
    const long long tlo = vlo + (nvec << 4);
    if (tid < hi - tlo) p[tlo + tid] = 0;
}

// Zero rows [*count, n) of buffer blockIdx.y: contiguous rows as one byte
// range over the whole grid, rows with a pitch one row a block at a time.
__global__ void __launch_bounds__(PT_TAIL_THREADS)
pt_zero_tail(PtTail t, const int* __restrict__ count, long long n) {
    char* __restrict__ p = nullptr;
    long long rb = 0, pitch = 0;
#pragma unroll
    for (int b = 0; b < PT_TAIL_MAX; ++b)   // no local copy of the table
        if (b == (int)blockIdx.y) {
            p = t.ptr[b];
            rb = t.row_bytes[b];
            pitch = t.pitch[b];
        }
    if (pitch == rb) {
        const long long lo = (long long)*count * rb, hi = n * rb;
        if (lo < hi)
            pt_zero_bytes(p, lo, hi,
                          (long long)blockIdx.x * blockDim.x + threadIdx.x,
                          (long long)gridDim.x * blockDim.x);
        return;
    }
    for (long long r = (long long)*count + blockIdx.x; r < n; r += gridDim.x)
        pt_zero_bytes(p + r * pitch, 0, rb, threadIdx.x, blockDim.x);
}

// Launch pt_zero_tail over n_bufs (1..PT_TAIL_MAX) buffers of n rows.
static inline cudaError_t pt_launch_zero_tail(const PtTail& t, int n_bufs,
                                              const int* count, long long n,
                                              cudaStream_t stream) {
    long long widest = 0;
    for (int b = 0; b < n_bufs; ++b)
        if (t.row_bytes[b] > widest) widest = t.row_bytes[b];
    const long long want =
        ((n * widest + 15) / 16 + PT_TAIL_THREADS - 1) / PT_TAIL_THREADS;
    const int blocks = want < 1 ? 1
                     : want > PT_TAIL_BLOCKS ? PT_TAIL_BLOCKS : (int)want;
    pt_zero_tail<<<dim3(blocks, n_bufs), PT_TAIL_THREADS, 0, stream>>>(
        t, count, n);
    return cudaGetLastError();
}
