// K5 blockwise_compact: stable compaction of the kept rows of several
// columns, globally, with the tail zeroed.
//
// One pass (Hopper design).  A block owns CP_ROWS consecutive rows, taken
// by ticket.  It first issues the 16-byte asynchronous copies of its rows
// of every column (raw bytes, so one kernel serves every dtype and (N, C)
// columns) into shared memory, so they are in flight while it reads its
// mask once (16 flags per 16-byte load), ranks its kept rows (popcounts of
// 16-flag groups, a scan of the 128 group counts), publishes its kept
// count and finds its global offset by the decoupled look-back of
// scan.cuh.  Then each kept row goes from shared memory to offset + rank:
// consecutive threads write consecutive units of the destination, reading
// their rows through the inverse of the ranks.  Rows too wide for all the
// columns' block of rows to fit CP_SLAB come in several parts.  The last
// block writes the kept count; a second small launch zeroes the output
// rows at or past it.  A call whose columns do not fit one launch
// (CP_MAX_COLS columns, CP_SLAB bytes of rows) launches again for the
// others; those launches take the offsets from the inclusive prefixes the
// first one published, so they neither look back nor race.
//
// A column may be a byte slice of wider rows: its rows are row_bytes wide
// and src_pitch (dst_pitch) bytes apart.  Such a column is staged a row at
// a time, each row in a slot of its own at its own offset mod 16, so the
// 16-byte copies still line up; a row wider than a launch takes is cut
// into such slices by the caller.  A later launch needs no look-back, so
// it spreads each block's parts over gridDim.y CTAs (part j of a block to
// CTA j mod gridDim.y): wide rows come a few a part, and a call with
// few blocks would otherwise walk them on a few SMs.  The caller then
// makes the first launch a rank-only one, with no columns.
//
// Bound: bytes (the mask and every row read once, every output row,
// kept or zeroed, written once).
#include <cuda_pipeline.h>

#include "common.cuh"
#include "scan.cuh"

#define CP_THREADS 256
#define CP_ROWS 2048
#define CP_GROUPS (CP_ROWS / 16)     // 16 rows: one 16-byte load of flags
#define CP_SLAB 36864                // bytes of the staged rows of a part
#define CP_MAX_COLS 8

struct CpCols {
    int n_cols;
    int part_rows;               // rows of a part: all columns fit CP_SLAB
    const unsigned char* src[CP_MAX_COLS];
    unsigned char* dst[CP_MAX_COLS];
    int row_bytes[CP_MAX_COLS];
    int src_pitch[CP_MAX_COLS];  // bytes from a row to the next
    int dst_pitch[CP_MAX_COLS];
    int slot[CP_MAX_COLS];       // staged bytes a row of a column whose
                                 // source has a pitch; 0: rows staged whole
    int unit[CP_MAX_COLS];       // bytes moved at a time: 1, 2, 4 or 8,
                                 // dividing the row, both pitches and both
                                 // addresses
    int smem_at[CP_MAX_COLS];    // the column's staging area, 16-aligned
};

// staged bytes a row of a column with a source pitch: the row at its own
// offset mod 16 in a 16-aligned slot
__host__ __device__ __forceinline__ int cp_slot_bytes(int row_bytes) {
    return (row_bytes + 30) & ~15;
}

// bits of the four bytes of w that are not zero
__device__ __forceinline__ uint32_t cp_flags4(uint32_t w) {
    const uint32_t t = __vcmpne4(w, 0u) & 0x08040201u;
    return (t | (t >> 8) | (t >> 16) | (t >> 24)) & 0xFu;
}

// Issue the copies of bytes [0, bytes) of g into sm[off + x], off = g & 15,
// so the 16-byte words of g and of sm line up.
__device__ __forceinline__ void cp_load(unsigned char* sm,
                                        const unsigned char* __restrict__ g,
                                        int bytes, int tid) {
    const int off = (int)((uintptr_t)g & 15);
    const int lead = (16 - off) & 15;
    const int head = lead < bytes ? lead : bytes;
    if (tid < head) sm[off + tid] = g[tid];
    const int nvec = (bytes - head) >> 4;
    for (int i = tid; i < nvec; i += CP_THREADS)
        __pipeline_memcpy_async(sm + off + head + 16 * i, g + head + 16 * i,
                                16);
    const int t0 = head + (nvec << 4);
    if (tid < bytes - t0) sm[off + t0 + tid] = g[t0 + tid];
}

// rank of block row r (< CP_ROWS) among the block's kept rows
__device__ __forceinline__ int cp_rank(const uint32_t* gmask,
                                       const int* grank, int r) {
    return grank[r >> 4] + __popc(gmask[r >> 4] & ((1u << (r & 15)) - 1u));
}

// Write the kept rows of ranks [k0, k1) (block rows from r0 on, the row of
// block row r0 at in) to their places (rank 0 at out, dpu units from a row
// to the next), in units of U, upr units a row: consecutive threads write
// consecutive units, each reading its row through the inverse of the
// ranks.
template <typename U>
__device__ __forceinline__ void cp_gather(const unsigned char* in,
                                          unsigned char* __restrict__ out,
                                          int r0, int k0, int k1, int upr,
                                          int dpu, const uint16_t* row_of,
                                          int tid) {
    const U* src = (const U*)in;
    U* __restrict__ dst = (U*)out;
    if (upr == 1 && dpu == 1) {
        for (int w = k0 + tid; w < k1; w += CP_THREADS)
            dst[w] = src[row_of[w] - r0];
        return;
    }
    for (int w = k0 * upr + tid; w < k1 * upr; w += CP_THREADS) {
        const int q = w / upr, e = w - q * upr;
        dst[(long long)q * dpu + e] = src[(row_of[q] - r0) * upr + e];
    }
}

// The same for a column staged a row a slot (slot bytes from one to the
// next, each row at the offset mod 16 of its source address; blk: the
// block's first source row).
template <typename U>
__device__ __forceinline__ void cp_gather_slots(
        const unsigned char* in, const unsigned char* blk, int src_pitch,
        int slot, unsigned char* __restrict__ out, int r0, int k0, int k1,
        int upr, int dpu, const uint16_t* row_of, int tid) {
    U* __restrict__ dst = (U*)out;
    for (int w = k0 * upr + tid; w < k1 * upr; w += CP_THREADS) {
        const int q = w / upr, e = w - q * upr, r = row_of[q];
        const U* row = (const U*)(
            in + (r - r0) * slot
            + ((uintptr_t)(blk + (long long)r * src_pitch) & 15));
        dst[(long long)q * dpu + e] = row[e];
    }
}

// Issue the copies of block rows [r0, r0 + nr) of every column: a
// contiguous column's as one byte range, a pitched column's a row a slot.
__device__ __forceinline__ void cp_stage(const CpCols& cols,
                                         unsigned char* sm, long long row0,
                                         int r0, int nr, int tid) {
    for (int c = 0; c < cols.n_cols; ++c) {
        const unsigned char* g =
            cols.src[c] + (row0 + r0) * cols.src_pitch[c];
        if (cols.slot[c] == 0) {
            cp_load(sm + cols.smem_at[c], g, nr * cols.row_bytes[c], tid);
            continue;
        }
        for (int i = 0; i < nr; ++i)
            cp_load(sm + cols.smem_at[c] + i * cols.slot[c],
                    g + (long long)i * cols.src_pitch[c], cols.row_bytes[c],
                    tid);
    }
    __pipeline_commit();
}

// first launch: ranked == 0 (ticket and look-back); later launches of the
// same call: ranked == 1 (block b's offset is the inclusive prefix block
// b - 1 published), block blockIdx.x's parts blockIdx.y, blockIdx.y +
// gridDim.y, ...
__global__ void __launch_bounds__(CP_THREADS)
compact_write(const uint8_t* __restrict__ keep, int n, int blocks,
              CpCols cols, int ranked,
              unsigned long long* __restrict__ status,
              int* __restrict__ count) {
    extern __shared__ __align__(16) unsigned char cp_sm[];
    __shared__ uint32_t gmask[CP_GROUPS];
    __shared__ int grank[CP_GROUPS];
    __shared__ uint16_t row_of[CP_ROWS];   // the block row of each rank
    __shared__ int warp_total[CP_GROUPS / 32];
    __shared__ int s_block, s_excl;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // status[0] is the ticket, status[1 + b] block b's status word
    if (tid == 0)
        s_block = ranked ? (int)blockIdx.x : (int)atomicAdd(status, 1ull);
    __syncthreads();
    const int b = s_block;
    const long long row0 = (long long)b * CP_ROWS;
    const int rows = n - row0 < CP_ROWS ? (int)(n - row0) : CP_ROWS;
    const int part = cols.part_rows;
    const int first = (int)blockIdx.y * part;    // this CTA's first part
    const int step = (int)gridDim.y * part;
    if (first >= rows) return;                   // a later launch's spare CTA

    // the first part's copies go out before the ranking
    cp_stage(cols, cp_sm, row0, first,
             rows - first < part ? rows - first : part, tid);

    // the mask, once: group g = tid < CP_GROUPS holds rows 16g .. 16g + 15
    uint32_t m = 0;
    if (tid < CP_GROUPS) {
        const int r = tid * 16;
        const uint8_t* kp = keep + row0 + r;
        if (r + 16 <= rows && (((uintptr_t)kp) & 15) == 0) {
            const uint4 v = *(const uint4*)kp;
            m = cp_flags4(v.x) | (cp_flags4(v.y) << 4)
                | (cp_flags4(v.z) << 8) | (cp_flags4(v.w) << 12);
        } else {
            for (int i = 0; i < 16 && r + i < rows; ++i)
                m |= (kp[i] != 0 ? 1u : 0u) << i;
        }
    }
    const int cnt = __popc(m);
    int incl = cnt;
    if (tid < CP_GROUPS) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(PT_FULL_MASK, incl, d);
            if (lane >= d) incl += y;
        }
        if (lane == 31) warp_total[warp] = incl;
    }
    __syncthreads();
    int below = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < CP_GROUPS / 32; ++w) {
        below += w < warp ? warp_total[w] : 0;
        kept += warp_total[w];
    }
    if (tid < CP_GROUPS) {
        gmask[tid] = m;
        grank[tid] = below + incl - cnt;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += CP_THREADS)
        if ((gmask[r >> 4] >> (r & 15)) & 1u)
            row_of[cp_rank(gmask, grank, r)] = (uint16_t)r;
    if (warp == 0) {
        const int excl =
            ranked ? (b == 0 ? 0 : (int)(uint32_t)status[b])
                   : pt_publish_and_look_back(status + 1, b, blocks, kept,
                                              count, lane);
        if (lane == 0) s_excl = excl;
    }

    for (int r0 = first; r0 < rows; r0 += step) {
        const int nr = rows - r0 < part ? rows - r0 : part;
        const int k0 = cp_rank(gmask, grank, r0);
        const int k1 =
            r0 + nr == rows ? kept : cp_rank(gmask, grank, r0 + nr);
        __pipeline_wait_prior(0);
        __syncthreads();
        for (int c = 0; c < cols.n_cols; ++c) {
            const int rb = cols.row_bytes[c], sp = cols.src_pitch[c];
            const unsigned char* blk = cols.src[c] + row0 * sp;
            unsigned char* out =
                cols.dst[c] + (long long)s_excl * cols.dst_pitch[c];
            const int u = cols.unit[c], upr = rb / u,
                      dpu = cols.dst_pitch[c] / u;
            if (cols.slot[c]) {
                const unsigned char* in = cp_sm + cols.smem_at[c];
                const int sl = cols.slot[c];
                switch (u) {
                case 8: cp_gather_slots<uint64_t>(in, blk, sp, sl, out, r0,
                                                  k0, k1, upr, dpu, row_of,
                                                  tid);
                        break;
                case 4: cp_gather_slots<uint32_t>(in, blk, sp, sl, out, r0,
                                                  k0, k1, upr, dpu, row_of,
                                                  tid);
                        break;
                case 2: cp_gather_slots<uint16_t>(in, blk, sp, sl, out, r0,
                                                  k0, k1, upr, dpu, row_of,
                                                  tid);
                        break;
                default: cp_gather_slots<uint8_t>(in, blk, sp, sl, out, r0,
                                                  k0, k1, upr, dpu, row_of,
                                                  tid);
                }
                continue;
            }
            const unsigned char* in = cp_sm + cols.smem_at[c]
                + ((uintptr_t)(blk + (long long)r0 * rb) & 15);
            switch (u) {
            case 8: cp_gather<uint64_t>(in, out, r0, k0, k1, upr, dpu,
                                        row_of, tid);
                    break;
            case 4: cp_gather<uint32_t>(in, out, r0, k0, k1, upr, dpu,
                                        row_of, tid);
                    break;
            case 2: cp_gather<uint16_t>(in, out, r0, k0, k1, upr, dpu,
                                        row_of, tid);
                    break;
            default: cp_gather<uint8_t>(in, out, r0, k0, k1, upr, dpu,
                                        row_of, tid);
            }
        }
        if (r0 + step < rows) {
            __syncthreads();      // every thread is done with this part
            cp_stage(cols, cp_sm, row0, r0 + step,
                     rows - r0 - step < part ? rows - r0 - step : part, tid);
        }
    }
}

// blocks must be ceil(n / CP_ROWS): the caller sized status to blocks + 1
// zeroed int64 words.  src, dst: host arrays of n_cols device pointers;
// row_bytes, src_pitch, dst_pitch, unit: host arrays of n_cols ints, each
// pitch at least the row; the staged bytes of a row (row_bytes for a
// contiguous source, cp_slot_bytes for one with a pitch) summing to at
// most CP_SLAB - 32 * CP_MAX_COLS.  count: an int32 the first launch of a
// call (ranked == 0) sets to the kept count; that launch may have no
// columns (n_cols == 0: it only ranks, publishes and counts).  Launches the
// write, then the zero tail of these columns.
extern "C" int compact_launch(const void* keep, int n, int blocks,
                              void* status, void* count, int ranked,
                              int n_cols, const void* const* src,
                              void* const* dst, const int* row_bytes,
                              const int* src_pitch, const int* dst_pitch,
                              const int* unit, void* stream) {
    if (n <= 0 || blocks != (n + CP_ROWS - 1) / CP_ROWS || n_cols < 0
        || n_cols > CP_MAX_COLS || (n_cols == 0 && ranked))
        return (int)cudaErrorInvalidValue;
    CpCols cols;
    PtTail tail;
    cols.n_cols = n_cols;
    long long bytes = 0;
    for (int c = 0; c < CP_MAX_COLS; ++c) {
        const bool on = c < n_cols;
        cols.src[c] = on ? (const unsigned char*)src[c] : nullptr;
        cols.dst[c] = on ? (unsigned char*)dst[c] : nullptr;
        cols.row_bytes[c] = on ? row_bytes[c] : 0;
        cols.src_pitch[c] = on ? src_pitch[c] : 0;
        cols.dst_pitch[c] = on ? dst_pitch[c] : 0;
        cols.unit[c] = on ? unit[c] : 1;
        if (on && (row_bytes[c] < 1 || (unit[c] != 1 && unit[c] != 2
                                        && unit[c] != 4 && unit[c] != 8)
                   || row_bytes[c] % unit[c] != 0
                   || src_pitch[c] < row_bytes[c]
                   || dst_pitch[c] < row_bytes[c]
                   || src_pitch[c] % unit[c] != 0
                   || dst_pitch[c] % unit[c] != 0))
            return (int)cudaErrorInvalidValue;
        const bool pitched = on && src_pitch[c] != row_bytes[c];
        cols.slot[c] = pitched ? cp_slot_bytes(row_bytes[c]) : 0;
        bytes += pitched ? cols.slot[c] : cols.row_bytes[c];
        tail.ptr[c] = (char*)cols.dst[c];
        tail.row_bytes[c] = cols.row_bytes[c];
        tail.pitch[c] = cols.dst_pitch[c];
    }
    if (bytes > CP_SLAB - 32 * CP_MAX_COLS) return (int)cudaErrorInvalidValue;
    const long long fit =
        bytes ? (CP_SLAB - 32 * CP_MAX_COLS) / bytes : CP_ROWS;
    cols.part_rows = fit < CP_ROWS ? (int)fit : CP_ROWS;
    int smem = 0;
    for (int c = 0; c < CP_MAX_COLS; ++c) {
        cols.smem_at[c] = smem;
        if (c < n_cols)
            smem += cols.slot[c]
                ? cols.part_rows * cols.slot[c]
                : (cols.part_rows * cols.row_bytes[c] + 16 + 15) & ~15;
    }
    // a later launch: enough CTAs for two a streaming multiprocessor, as
    // far as the blocks have parts
    int splits = 1;
    if (ranked) {
        int dev = 0, sms = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
        const int rows = n < CP_ROWS ? n : CP_ROWS;
        const int parts = (rows + cols.part_rows - 1) / cols.part_rows;
        const int want = (2 * sms + blocks - 1) / blocks;
        splits = want < parts ? want : parts;
    }
    compact_write<<<dim3(blocks, splits), CP_THREADS, smem,
                    (cudaStream_t)stream>>>(
        (const uint8_t*)keep, n, blocks, cols, ranked,
        (unsigned long long*)status, (int*)count);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_cols == 0) return (int)e;
    return (int)pt_launch_zero_tail(tail, n_cols, (const int*)count, n,
                                    (cudaStream_t)stream);
}
