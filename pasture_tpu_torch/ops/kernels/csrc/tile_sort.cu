// K4 tile_sort: unstable ascending sort of independent power-of-two tiles
// of 1-5 parallel 32-bit streams.  The first NK streams are a lexicographic
// UNSIGNED key; the other streams move with their row.
//
// Replaces pasture_tpu/ops/kernels/tile_sort_kernel.py tile_sort_pallas
// (_make_kernel).  Bound on the H100: bytes (each stream read and written
// once); what a sort adds is the bitonic network's log2(L)(log2(L)+1)/2
// compare-exchange substages (45 at L = 512).  The first design ran all of
// them in shared memory, one block a tile, each substage behind a barrier
// and ~10 shared words per pair: bound by shared-memory traffic.
//
// This design keeps the rows in registers.  Each thread holds E = 16
// consecutive rows of its tile (E = L below 16 rows), loaded and stored
// with 16-byte vector accesses; a tile takes L / E threads (one warp at
// L = 512), and a block takes as many tiles as give it at least 128
// threads.  A substage whose partner distance j is
//   j < E        runs inside the thread, on registers, fully unrolled;
//   E <= j < 32E runs between lanes: __shfl_xor_sync of every word of
//                every row, each lane keeping the smaller or the larger;
//   j >= 32E     runs through shared memory: every thread writes its rows,
//                a barrier, then reads its partner's rows, four at a time.
// At L = 512 that is 30 substages of 45 on registers, 15 by shuffles and
// none through shared memory; at L = 4096, 6 of 78 through shared memory.
// The key of a row is compared as one unsigned integer (key << 32 | word
// where NK = 2), so the invalid key 0xFFFFFFFF and words with the top bit
// set sort last.  Payload words follow their key through selects, with no
// divergent branches.  Partners across lanes or through shared memory
// swap only on a strict comparison, so rows with equal keys stay where
// they are on both sides and no row is lost or doubled; inside a thread a
// swap of equal keys is harmless.  What bounds it now: the shuffles (one
// per word per row per cross-lane substage: 45 a row at three streams)
// and ~4 issued instructions per row per register substage.
//
// nvcc -Xptxas -v with the build's flags (CUDA 12.8, sm_90a): 90 registers
// at three streams and 142 at five (two keys, 16 rows a thread), no stack
// or spills; the instance for 8-row tiles of five streams and one key
// spills 8 bytes (no path sorts such tiles).
#include "common.cuh"

#define TS_E 16              // rows a thread from 16-row tiles up
#define TS_MIN_THREADS 128
#define TS_FULL 0xffffffffu

// row a's key greater than row b's (unsigned, lexicographic)
template <int NS, int NK>
__device__ __forceinline__ bool key_gt(const uint32_t (&a)[NS],
                                       const uint32_t (&b)[NS]) {
    if constexpr (NK == 1) {
        return a[0] > b[0];
    } else {
        return (((uint64_t)a[0] << 32) | a[1])
               > (((uint64_t)b[0] << 32) | b[1]);
    }
}

// rows a (the lower position) and b of one thread: ascending puts the
// smaller key at a
template <int NS, int NK>
__device__ __forceinline__ void cx(uint32_t (&a)[NS], uint32_t (&b)[NS],
                                   bool desc) {
    const bool swap = key_gt<NS, NK>(a, b) != desc;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const uint32_t x = a[s], y = b[s];
        a[s] = swap ? y : x;
        b[s] = swap ? x : y;
    }
}

// one side of a pair split across threads: mine against the partner's o.
// f (ascending == I hold the lower position) means I keep the smaller key:
// take o iff mine > o; otherwise take o iff o > mine.  Both strict, so a
// tie leaves both rows where they are.
template <int NS, int NK>
__device__ __forceinline__ void keep(uint32_t (&mine)[NS],
                                     const uint32_t (&o)[NS], bool f) {
    const bool take = f ? key_gt<NS, NK>(mine, o) : key_gt<NS, NK>(o, mine);
#pragma unroll
    for (int s = 0; s < NS; ++s) mine[s] = take ? o[s] : mine[s];
}

// E consecutive words at p (16-byte aligned for E >= 4, 8 for E = 2)
template <int E, int NS>
__device__ __forceinline__ void load_rows(const uint32_t* p,
                                          uint32_t (&v)[E][NS], int s) {
    if constexpr (E == 2) {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
        v[0][s] = a.x;
        v[1 % E][s] = a.y;
    } else {
#pragma unroll
        for (int h = 0; h < E / 4; ++h) {
            const uint4 a = reinterpret_cast<const uint4*>(p)[h];
            v[(4 * h) % E][s] = a.x;
            v[(4 * h + 1) % E][s] = a.y;
            v[(4 * h + 2) % E][s] = a.z;
            v[(4 * h + 3) % E][s] = a.w;
        }
    }
}

template <int E, int NS>
__device__ __forceinline__ void store_rows(uint32_t* p,
                                           const uint32_t (&v)[E][NS],
                                           int s) {
    if constexpr (E == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(v[0][s], v[1 % E][s]);
    } else {
#pragma unroll
        for (int h = 0; h < E / 4; ++h)
            reinterpret_cast<uint4*>(p)[h] = make_uint4(
                v[(4 * h) % E][s], v[(4 * h + 1) % E][s],
                v[(4 * h + 2) % E][s], v[(4 * h + 3) % E][s]);
    }
}

template <int NS, int NK, int E>
__global__ void
__launch_bounds__(E == TS_E ? 4096 / TS_E : TS_MIN_THREADS)
tile_sort_kernel(const uint32_t* __restrict__ i0,
                 const uint32_t* __restrict__ i1,
                 const uint32_t* __restrict__ i2,
                 const uint32_t* __restrict__ i3,
                 const uint32_t* __restrict__ i4, uint32_t* __restrict__ o0,
                 uint32_t* __restrict__ o1, uint32_t* __restrict__ o2,
                 uint32_t* __restrict__ o3, uint32_t* __restrict__ o4,
                 int tiles, int tile_len) {
    extern __shared__ uint32_t sm[];   // NS arrays of blockDim.x * E words
    const uint32_t* in[5] = {i0, i1, i2, i3, i4};
    uint32_t* out[5] = {o0, o1, o2, o3, o4};
    const int tpt = tile_len / E;                    // threads per tile
    const int lt = threadIdx.x & (tpt - 1);
    const long long tile = (long long)blockIdx.x * (blockDim.x / tpt)
                           + threadIdx.x / tpt;
    // threads of a tile past the last stay for the shuffles and barriers
    const bool live = tile < tiles;
    const int tbase = lt * E;                        // my first row
    const long long g = tile * tile_len + tbase;
    uint32_t v[E][NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        if (live) {
            load_rows<E, NS>(in[s] + g, v, s);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) v[e][s] = 0u;
        }
    }

    // k = 2 .. E: inside the thread; the direction of a pair is bit k of
    // its lower row's position
#pragma unroll
    for (int k = 2; k <= E; k <<= 1)
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
            for (int e = 0; e < E; ++e)
                if ((e & j) == 0)
                    cx<NS, NK>(v[e], v[e + j], ((tbase + e) & k) != 0);

    const int bw = blockDim.x * E;   // words of one stream in shared memory
    for (int k = 2 * E; k <= tile_len; k <<= 1) {
        const bool desc = (tbase & k) != 0;          // one bit of tbase
        for (int j = k >> 1; j >= E; j >>= 1) {
            // ascending == lower position: I keep the smaller key
            const bool f = desc == ((tbase & j) != 0);
            if (j < 32 * E) {
                const int m = j / E;                 // partner lane
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    uint32_t o[NS];
#pragma unroll
                    for (int s = 0; s < NS; ++s)
                        o[s] = __shfl_xor_sync(TS_FULL, v[e][s], m);
                    keep<NS, NK>(v[e], o, f);
                }
            } else if constexpr (E >= 4) {
                // the partner's rows are the E rows at (my first) ^ j;
                // read four at a time (one 16-byte word of each stream)
                __syncthreads();
#pragma unroll
                for (int s = 0; s < NS; ++s)
                    store_rows<E, NS>(sm + s * bw + threadIdx.x * E, v, s);
                __syncthreads();
                const uint32_t* pb = sm + ((threadIdx.x * E) ^ j);
#pragma unroll
                for (int h = 0; h < E; h += 4) {
                    uint32_t o[4][NS];
#pragma unroll
                    for (int s = 0; s < NS; ++s)
                        load_rows<4, NS>(pb + s * bw + h, o, s);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        keep<NS, NK>(v[h + e], o[e], f);
                }
            }
        }
#pragma unroll
        for (int j = E >> 1; j > 0; j >>= 1)
#pragma unroll
            for (int e = 0; e < E; ++e)
                if ((e & j) == 0) cx<NS, NK>(v[e], v[e + j], desc);
    }

    if (live) {
#pragma unroll
        for (int s = 0; s < NS; ++s) store_rows<E, NS>(out[s] + g, v, s);
    }
}

template <int NS, int NK, int E>
static int launch_e(const void* const* in, void* const* out, int tiles,
                    int tile_len, cudaStream_t st) {
    const int tpt = tile_len / E;
    const int threads = tpt > TS_MIN_THREADS ? tpt : TS_MIN_THREADS;
    const int per_block = threads / tpt;
    const size_t smem = tile_len > 32 * E
        ? (size_t)NS * threads * E * sizeof(uint32_t) : 0;
    // five streams of 4096 rows are 80 KiB: above the 48 KiB a block gets
    // without opting in to the large carve-out
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            tile_sort_kernel<NS, NK, E>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (tiles + per_block - 1) / per_block;
    tile_sort_kernel<NS, NK, E><<<blocks, threads, smem, st>>>(
        (const uint32_t*)in[0], (const uint32_t*)in[1],
        (const uint32_t*)in[2], (const uint32_t*)in[3],
        (const uint32_t*)in[4], (uint32_t*)out[0], (uint32_t*)out[1],
        (uint32_t*)out[2], (uint32_t*)out[3], (uint32_t*)out[4], tiles,
        tile_len);
    return (int)cudaGetLastError();
}

template <int NS, int NK>
static int launch(const void* const* in, void* const* out, int tiles,
                  int tile_len, cudaStream_t st) {
    if (tile_len == 2) return launch_e<NS, NK, 2>(in, out, tiles, 2, st);
    if (tile_len == 4) return launch_e<NS, NK, 4>(in, out, tiles, 4, st);
    if (tile_len == 8) return launch_e<NS, NK, 8>(in, out, tiles, 8, st);
    return launch_e<NS, NK, TS_E>(in, out, tiles, tile_len, st);
}

// Streams: 16-byte aligned (the wrapper sees to it).  tile_len a power of
// two in [2, 4096].
extern "C" int tile_sort_launch(const void* in0, const void* in1,
                                const void* in2, const void* in3,
                                const void* in4, void* out0, void* out1,
                                void* out2, void* out3, void* out4,
                                int n_streams, int num_keys, int tiles,
                                int tile_len, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const void* in[5] = {in0, in1, in2, in3, in4};
    void* out[5] = {out0, out1, out2, out3, out4};
    if (num_keys < 1 || num_keys > 2 || num_keys > n_streams || tiles < 1
        || tile_len < 2 || tile_len > 4096 || (tile_len & (tile_len - 1)))
        return (int)cudaErrorInvalidValue;
#define PT_CASE(NS, NK) \
    if (n_streams == NS && num_keys == NK) \
        return launch<NS, NK>(in, out, tiles, tile_len, s);
    PT_CASE(1, 1) PT_CASE(2, 1) PT_CASE(2, 2) PT_CASE(3, 1) PT_CASE(3, 2)
    PT_CASE(4, 1) PT_CASE(4, 2) PT_CASE(5, 1) PT_CASE(5, 2)
#undef PT_CASE
    return (int)cudaErrorInvalidValue;
}
