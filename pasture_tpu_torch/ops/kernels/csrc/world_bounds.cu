// K1 fused_world_bounds: min and max per axis of rot.(local*scale)+trans
// over (N, 3) int32 local coordinates; world coordinates are never written.
//
// Replaces pasture_tpu/ops/kernels/fused_transform.py fused_world_bounds
// (_bounds_kernel).  Bound on the H100: bytes (12 B read per point, 24 B
// written), a few dozen float operations per point.
//
// One launch (Hopper design).  Each thread loads the 15 parameters (scale
// 3, rotation 9, translation 3: three device pointers, so a translation
// computed on the device is never read on the host) into registers through
// the read-only path.  The (N, 3) array is read as a flat stream of
// 16-byte words: four points are 48 bytes, three int4 loads, and a thread
// issues WB_GROUPS such groups before it uses any of them.  Points before
// the first 16-byte boundary of the base (a row-offset view) and after the
// last whole group are taken one by one by the first threads of the grid.
// The grid is the SM count times WB_BLOCKS_PER_SM.  Each block reduces its
// minima and maxima (warp shuffles, then shared memory) to one (6,)
// partial, publishes it (__threadfence, then an atomicAdd on a ticket),
// and the block that draws the last ticket folds every partial into the
// output and sets the ticket back to zero for the next call on the stream.
#include "common.cuh"

#define WB_THREADS 256
#define WB_WARPS (WB_THREADS / 32)
#define WB_GROUPS 2             // 4-point groups a thread has in flight
#define WB_BLOCKS_PER_SM 4

struct WbParams {
    float s[3], r[9], t[3];
};

__device__ __forceinline__ void wb_point(const WbParams& p, int x, int y,
                                         int z, float v[6]) {
    const float wx = (float)x * p.s[0];
    const float wy = (float)y * p.s[1];
    const float wz = (float)z * p.s[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float w = pt_affine_row(p.r + 3 * a, p.t[a], wx, wy, wz);
        v[a] = fminf(v[a], w);
        v[3 + a] = fmaxf(v[3 + a], w);
    }
}

// Block-wide reduction of v (sh holds the warps' values): thread c < 6
// returns component c of the result.
__device__ __forceinline__ float wb_block_reduce(const float v[6],
                                                 float (*sh)[WB_WARPS]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        float x = v[c];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            const float y = __shfl_xor_sync(0xFFFFFFFFu, x, d);
            x = c < 3 ? fminf(x, y) : fmaxf(x, y);
        }
        if (lane == 0) sh[c][warp] = x;
    }
    __syncthreads();
    float x = 0.0f;
    if (threadIdx.x < 6) {
        const int c = threadIdx.x;
        x = sh[c][0];
#pragma unroll
        for (int w = 1; w < WB_WARPS; ++w)
            x = c < 3 ? fminf(x, sh[c][w]) : fmaxf(x, sh[c][w]);
    }
    return x;
}

__global__ void __launch_bounds__(WB_THREADS, WB_BLOCKS_PER_SM)
world_bounds(const int* __restrict__ local, long long n,
             const float* __restrict__ scale, const float* __restrict__ rot,
             const float* __restrict__ trans, float* __restrict__ partials,
             unsigned int* __restrict__ ticket, float* __restrict__ out) {
    __shared__ float sh[6][WB_WARPS];
    __shared__ bool s_last;
    WbParams p;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        p.s[i] = __ldg(scale + i);
        p.t[i] = __ldg(trans + i);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) p.r[i] = __ldg(rot + i);

    const float inf = __int_as_float(0x7F800000);
    float v[6] = {inf, inf, inf, -inf, -inf, -inf};
    const long long tid = (long long)blockIdx.x * WB_THREADS + threadIdx.x;
    const long long threads = (long long)gridDim.x * WB_THREADS;
    // points before the first 16-byte boundary: 0-3 (the base is 4-aligned)
    long long head = (long long)(((uintptr_t)local & 15) >> 2);
    if (head > n) head = n;
    const long long groups = (n - head) >> 2;
    const long long body_end = head + 4 * groups;
    if (tid < head)
        wb_point(p, local[3 * tid], local[3 * tid + 1], local[3 * tid + 2],
                 v);
    if (tid < n - body_end) {
        const long long i = body_end + tid;
        wb_point(p, local[3 * i], local[3 * i + 1], local[3 * i + 2], v);
    }
    const int4* __restrict__ q = (const int4*)(local + 3 * head);
    for (long long g0 = tid; g0 < groups; g0 += WB_GROUPS * threads) {
        int4 w[WB_GROUPS][3];
#pragma unroll
        for (int k = 0; k < WB_GROUPS; ++k) {
            const long long g = g0 + k * threads;
            if (g < groups) {
                w[k][0] = __ldg(q + 3 * g);
                w[k][1] = __ldg(q + 3 * g + 1);
                w[k][2] = __ldg(q + 3 * g + 2);
            }
        }
#pragma unroll
        for (int k = 0; k < WB_GROUPS; ++k) {
            if (g0 + k * threads < groups) {
                const int4 a = w[k][0], b = w[k][1], c = w[k][2];
                wb_point(p, a.x, a.y, a.z, v);
                wb_point(p, a.w, b.x, b.y, v);
                wb_point(p, b.z, b.w, c.x, v);
                wb_point(p, c.y, c.z, c.w, v);
            }
        }
    }

    const float part = wb_block_reduce(v, sh);
    if (threadIdx.x < 6) {
        partials[6 * blockIdx.x + threadIdx.x] = part;
        __threadfence();                // the partial before the ticket
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        if (s_last) __threadfence();    // every partial before the fold
    }
    __syncthreads();
    if (!s_last) return;
    // the last block: fold the partials (read at L2, where the other
    // blocks' stores are)
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c] = c < 3 ? inf : -inf;
    for (int b = threadIdx.x; b < gridDim.x; b += WB_THREADS) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            v[c] = fminf(v[c], __ldcg(partials + 6 * b + c));
            v[3 + c] = fmaxf(v[3 + c], __ldcg(partials + 6 * b + 3 + c));
        }
    }
    __syncthreads();                    // sh is reused
    const float total = wb_block_reduce(v, sh);
    if (threadIdx.x < 6) out[threadIdx.x] = total;
    if (threadIdx.x == 0) *ticket = 0u;
}

// The most blocks a call launches: the current device's SM count times
// WB_BLOCKS_PER_SM (the partials of a workspace).
extern "C" int world_bounds_max_blocks(int* blocks) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *blocks = sms * WB_BLOCKS_PER_SM;
    return 0;
}

// local: (n, 3) int32, 4-byte aligned, n >= 1.  scale (3), rot (9, row-
// major), trans (3): f32 on the device.  work: a zeroed unsigned ticket
// followed, 16 bytes on, by room for max_blocks (6,) f32 partials, owned by
// this stream (the last block sets the ticket back to zero).  out: (6,) f32
// = min xyz, max xyz.
extern "C" int world_bounds_launch(const void* local, int n, const void* scale,
                                   const void* rot, const void* trans,
                                   void* work, int max_blocks, void* out,
                                   void* stream) {
    if (n < 1 || max_blocks < 1 || ((uintptr_t)local & 3))
        return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)WB_THREADS * WB_GROUPS * 4;
    const long long want = (n + per_block - 1) / per_block;
    const int blocks = want < max_blocks ? (int)want : max_blocks;
    world_bounds<<<blocks, WB_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)local, n, (const float*)scale, (const float*)rot,
        (const float*)trans, (float*)work + 4, (unsigned int*)work,
        (float*)out);
    return (int)cudaGetLastError();
}
