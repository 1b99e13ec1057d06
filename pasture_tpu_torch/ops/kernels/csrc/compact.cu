// K5 blockwise_compact: stable compaction of the kept rows of several
// columns, globally, with the tail zeroed.
//
// A block owns CP_ROWS consecutive rows.  Launch 1 (count): kept rows per
// block.  The caller's exclusive cumsum of those counts gives each block its
// global output offset and the total.  Launch 2 (write): the block ranks its
// kept rows again — one row per thread per pass, a warp ballot ranks the 32
// rows of a warp, a scan of the (pass, warp) counts in shared memory ranks
// the warps — and copies each kept row of every column to
// offsets[block] + rank.  Reads and writes are coalesced: neighbouring
// threads hold neighbouring rows, and kept rows land on neighbouring
// destinations.  A row is its raw bytes, moved in units of 1, 2, 4 or
// 8 bytes, so one kernel serves every column type and (N, C) columns.  Rows
// of the output at or past the total are zeroed by the block that owns
// their index, so the outputs need no memset.
#include "common.cuh"

#define CP_THREADS 256
#define CP_WARPS (CP_THREADS / 32)
#define CP_PASSES 8
#define CP_ROWS (CP_THREADS * CP_PASSES)
#define CP_MAX_COLS 8

struct CpCols {
    int n_cols;
    const char* src[CP_MAX_COLS];
    char* dst[CP_MAX_COLS];
    int units[CP_MAX_COLS];   // units per row
    int unit[CP_MAX_COLS];    // bytes per unit: 1, 2, 4 or 8
};

// Ballots of this thread's warp for each pass into bits[]; exclusive ranks
// of every (pass, warp) group into wrank[] (pass-major: rows of pass j come
// before rows of pass j + 1); returns the block's kept count.
__device__ __forceinline__ int cp_block_ranks(const uint8_t* __restrict__ keep,
                                              long long base, int n,
                                              uint32_t bits[CP_PASSES],
                                              int* wrank) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < CP_PASSES; ++j) {
        const long long i = base + j * CP_THREADS + threadIdx.x;
        const bool k = i < n && keep[i] != 0;
        bits[j] = __ballot_sync(0xFFFFFFFFu, k);
        if (lane == 0) wrank[j * CP_WARPS + warp] = __popc(bits[j]);
    }
    __syncthreads();
    __shared__ int total;
    if (warp == 0) {
        // 64 counts, two per lane
        const int a = wrank[2 * lane], b = wrank[2 * lane + 1];
        int incl = a + b;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (lane >= d) incl += y;
        }
        const int excl = incl - (a + b);
        wrank[2 * lane] = excl;
        wrank[2 * lane + 1] = excl + a;
        if (lane == 31) total = incl;
    }
    __syncthreads();
    return total;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_count(const uint8_t* __restrict__ keep, int n,
              int* __restrict__ counts) {
    __shared__ int wrank[CP_PASSES * CP_WARPS];
    uint32_t bits[CP_PASSES];
    const int total =
        cp_block_ranks(keep, (long long)blockIdx.x * CP_ROWS, n, bits, wrank);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename U>
__device__ __forceinline__ void cp_move(const char* src, char* dst,
                                        long long from, long long to,
                                        int units) {
    const U* s = (const U*)src + from * units;
    U* d = (U*)dst + to * units;
    for (int u = 0; u < units; ++u) d[u] = s[u];
}

template <typename U>
__device__ __forceinline__ void cp_zero(char* dst, long long row, int units) {
    U* d = (U*)dst + row * units;
    for (int u = 0; u < units; ++u) d[u] = (U)0;
}

__global__ void __launch_bounds__(CP_THREADS)
compact_write(const uint8_t* __restrict__ keep, int n,
              const int* __restrict__ offsets,
              const int* __restrict__ total_ptr, CpCols cols) {
    __shared__ int wrank[CP_PASSES * CP_WARPS];
    uint32_t bits[CP_PASSES];
    const long long base = (long long)blockIdx.x * CP_ROWS;
    cp_block_ranks(keep, base, n, bits, wrank);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long out_base = offsets[blockIdx.x];
    const long long total = *total_ptr;
#pragma unroll
    for (int j = 0; j < CP_PASSES; ++j) {
        const long long i = base + j * CP_THREADS + threadIdx.x;
        if (i >= n) continue;
        if ((bits[j] >> lane) & 1u) {
            const long long o = out_base + wrank[j * CP_WARPS + warp]
                + __popc(bits[j] & ((1u << lane) - 1u));
            for (int c = 0; c < cols.n_cols; ++c) {
                switch (cols.unit[c]) {
                case 8: cp_move<uint64_t>(cols.src[c], cols.dst[c], i, o, cols.units[c]); break;
                case 4: cp_move<uint32_t>(cols.src[c], cols.dst[c], i, o, cols.units[c]); break;
                case 2: cp_move<uint16_t>(cols.src[c], cols.dst[c], i, o, cols.units[c]); break;
                default: cp_move<uint8_t>(cols.src[c], cols.dst[c], i, o, cols.units[c]);
                }
            }
        }
        // output row i itself: no kept row lands at or past the total
        if (i >= total) {
            for (int c = 0; c < cols.n_cols; ++c) {
                switch (cols.unit[c]) {
                case 8: cp_zero<uint64_t>(cols.dst[c], i, cols.units[c]); break;
                case 4: cp_zero<uint32_t>(cols.dst[c], i, cols.units[c]); break;
                case 2: cp_zero<uint16_t>(cols.dst[c], i, cols.units[c]); break;
                default: cp_zero<uint8_t>(cols.dst[c], i, cols.units[c]);
                }
            }
        }
    }
}

static_assert(CP_PASSES * CP_WARPS == 64, "the rank scan holds two counts per lane");

// blocks must be ceil(n / CP_ROWS): the caller sized counts / offsets by it
extern "C" int compact_count_launch(const void* keep, int n, int blocks,
                                    void* counts, void* stream) {
    if (n <= 0 || blocks != (n + CP_ROWS - 1) / CP_ROWS)
        return (int)cudaErrorInvalidValue;
    compact_count<<<blocks, CP_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)keep, n, (int*)counts);
    return (int)cudaGetLastError();
}

// src, dst: host arrays of n_cols device pointers; units, unit: host arrays
// of n_cols ints.
extern "C" int compact_write_launch(const void* keep, int n, int blocks,
                                    const void* offsets, const void* total,
                                    int n_cols, const void* const* src,
                                    void* const* dst, const int* units,
                                    const int* unit, void* stream) {
    if (n <= 0 || blocks != (n + CP_ROWS - 1) / CP_ROWS || n_cols < 1
        || n_cols > CP_MAX_COLS)
        return (int)cudaErrorInvalidValue;
    CpCols cols;
    cols.n_cols = n_cols;
    for (int c = 0; c < CP_MAX_COLS; ++c) {
        const bool on = c < n_cols;
        cols.src[c] = on ? (const char*)src[c] : nullptr;
        cols.dst[c] = on ? (char*)dst[c] : nullptr;
        cols.units[c] = on ? units[c] : 0;
        cols.unit[c] = on ? unit[c] : 1;
        if (on && unit[c] != 1 && unit[c] != 2 && unit[c] != 4 && unit[c] != 8)
            return (int)cudaErrorInvalidValue;
    }
    compact_write<<<blocks, CP_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)keep, n, (const int*)offsets, (const int*)total, cols);
    return (int)cudaGetLastError();
}
