// K4 tile_sort: unstable ascending sort of independent power-of-two tiles
// of 1-5 parallel 32-bit streams.  The first NK streams are a lexicographic
// UNSIGNED key; the other streams move with their row.
//
// One block per tile: the tile's streams are loaded into shared memory, a
// bitonic network of compare-exchanges runs there (each thread owns one
// pair per substage), and the sorted streams are written back — one read
// and one write of device memory per stream.
#include "common.cuh"

template <int NS, int NK>
__global__ void tile_sort_kernel(const uint32_t* __restrict__ i0,
                                 const uint32_t* __restrict__ i1,
                                 const uint32_t* __restrict__ i2,
                                 const uint32_t* __restrict__ i3,
                                 const uint32_t* __restrict__ i4,
                                 uint32_t* __restrict__ o0,
                                 uint32_t* __restrict__ o1,
                                 uint32_t* __restrict__ o2,
                                 uint32_t* __restrict__ o3,
                                 uint32_t* __restrict__ o4, int tile_len) {
    extern __shared__ uint32_t sm[];   // NS arrays of tile_len words
    const uint32_t* in[5] = {i0, i1, i2, i3, i4};
    uint32_t* out[5] = {o0, o1, o2, o3, o4};
    const long long base = (long long)blockIdx.x * tile_len;
#pragma unroll
    for (int s = 0; s < NS; ++s)
        for (int i = threadIdx.x; i < tile_len; i += blockDim.x)
            sm[s * tile_len + i] = in[s][base + i];
    __syncthreads();
    const int pairs = tile_len >> 1;
    for (int k = 2; k <= tile_len; k <<= 1) {
        for (int j = k >> 1; j >= 1; j >>= 1) {
            for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
                const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                const int hi = lo | j;
                const bool ascending = (lo & k) == 0;
                // is row lo lexicographically greater than row hi?
                bool greater = false, less = false;
#pragma unroll
                for (int q = 0; q < NK; ++q) {
                    const uint32_t a = sm[q * tile_len + lo];
                    const uint32_t b = sm[q * tile_len + hi];
                    if (!greater && !less) {
                        greater = a > b;
                        less = a < b;
                    }
                }
                if (ascending ? greater : less) {
#pragma unroll
                    for (int s = 0; s < NS; ++s) {
                        const uint32_t a = sm[s * tile_len + lo];
                        sm[s * tile_len + lo] = sm[s * tile_len + hi];
                        sm[s * tile_len + hi] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
        for (int i = threadIdx.x; i < tile_len; i += blockDim.x)
            out[s][base + i] = sm[s * tile_len + i];
}

template <int NS, int NK>
static int launch(const void* const* in, void* const* out, int tiles,
                  int tile_len, cudaStream_t s) {
    // five streams of 4096 rows are 80 KiB: above the 48 KiB a block gets
    // without opting in to the large carve-out
    const size_t smem = (size_t)NS * tile_len * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            tile_sort_kernel<NS, NK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = tile_len / 2;
    if (threads < 32) threads = 32;
    if (threads > 512) threads = 512;
    tile_sort_kernel<NS, NK><<<tiles, threads, smem, s>>>(
        (const uint32_t*)in[0], (const uint32_t*)in[1],
        (const uint32_t*)in[2], (const uint32_t*)in[3],
        (const uint32_t*)in[4], (uint32_t*)out[0], (uint32_t*)out[1],
        (uint32_t*)out[2], (uint32_t*)out[3], (uint32_t*)out[4], tile_len);
    return (int)cudaGetLastError();
}

extern "C" int tile_sort_launch(const void* in0, const void* in1,
                                const void* in2, const void* in3,
                                const void* in4, void* out0, void* out1,
                                void* out2, void* out3, void* out4,
                                int n_streams, int num_keys, int tiles,
                                int tile_len, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const void* in[5] = {in0, in1, in2, in3, in4};
    void* out[5] = {out0, out1, out2, out3, out4};
    if (num_keys < 1 || num_keys > 2 || num_keys > n_streams)
        return (int)cudaErrorInvalidValue;
#define PT_CASE(NS, NK) \
    if (n_streams == NS && num_keys == NK) \
        return launch<NS, NK>(in, out, tiles, tile_len, s);
    PT_CASE(1, 1) PT_CASE(2, 1) PT_CASE(2, 2) PT_CASE(3, 1) PT_CASE(3, 2)
    PT_CASE(4, 1) PT_CASE(4, 2) PT_CASE(5, 1) PT_CASE(5, 2)
#undef PT_CASE
    return (int)cudaErrorInvalidValue;
}
