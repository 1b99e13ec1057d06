// K1 fused_world_bounds: min and max per axis of rot.(local*scale)+trans
// over (N, 3) int32 local coordinates; world coordinates are never written.
//
// Launch 1: grid-stride loop, per-thread minima/maxima in registers, warp
// shuffle reduce, shared-memory block reduce, one (6,) partial per block.
// Launch 2: one block folds the partials into out[0:3] = min, out[3:6] = max.
#include "common.cuh"

#define WB_THREADS 256

__device__ __forceinline__ void wb_block_reduce(float v[6], float* out6) {
    __shared__ float sh[6][WB_THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        float x = v[c];
        for (int d = 16; d > 0; d >>= 1) {
            float y = __shfl_down_sync(0xFFFFFFFFu, x, d);
            x = (c < 3) ? fminf(x, y) : fmaxf(x, y);
        }
        if (lane == 0) sh[c][warp] = x;
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        const int c = threadIdx.x;
        float x = sh[c][0];
        for (int w = 1; w < WB_THREADS / 32; ++w)
            x = (c < 3) ? fminf(x, sh[c][w]) : fmaxf(x, sh[c][w]);
        out6[c] = x;
    }
}

__global__ void __launch_bounds__(WB_THREADS)
world_bounds_partial(const int* __restrict__ local, int n,
                     const float* __restrict__ params,
                     float* __restrict__ partials) {
    __shared__ float p[15];
    if (threadIdx.x < 15) p[threadIdx.x] = params[threadIdx.x];
    __syncthreads();
    const float inf = __int_as_float(0x7F800000);
    float v[6] = {inf, inf, inf, -inf, -inf, -inf};
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const float wx = (float)local[3 * i + 0] * p[0];
        const float wy = (float)local[3 * i + 1] * p[1];
        const float wz = (float)local[3 * i + 2] * p[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float t = pt_affine_row(p + 3 + 3 * a, p[12 + a], wx, wy, wz);
            v[a] = fminf(v[a], t);
            v[3 + a] = fmaxf(v[3 + a], t);
        }
    }
    wb_block_reduce(v, partials + 6 * blockIdx.x);
}

__global__ void __launch_bounds__(WB_THREADS)
world_bounds_fold(const float* __restrict__ partials, int blocks,
                  float* __restrict__ out) {
    const float inf = __int_as_float(0x7F800000);
    float v[6] = {inf, inf, inf, -inf, -inf, -inf};
    for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            v[c] = fminf(v[c], partials[6 * b + c]);
            v[3 + c] = fmaxf(v[3 + c], partials[6 * b + 3 + c]);
        }
    }
    wb_block_reduce(v, out);
}

extern "C" int world_bounds_launch(const void* local, int n,
                                   const void* params, void* partials,
                                   int blocks, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    world_bounds_partial<<<blocks, WB_THREADS, 0, s>>>(
        (const int*)local, n, (const float*)params, (float*)partials);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    world_bounds_fold<<<1, WB_THREADS, 0, s>>>((const float*)partials, blocks,
                                               (float*)out);
    return (int)cudaGetLastError();
}
