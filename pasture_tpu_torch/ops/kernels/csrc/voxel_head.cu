// K2 fused_voxel_head_exact_local: per point, decode + rotate + translate,
// cell = clip(floor((t - bmin) * inv_leaf [- 0.5 for nearest]), 0, 1023),
// 30-bit Morton key, and the word rx<<20 | ry<<10 | rz of the exact 10-bit
// residuals r = clip(local - cell_base(coef, cell), 0, 1023).
//
// One thread per point; the (N, 3) int32 tensor is read as it is.
// params = scale(3) rot(9) trans(3) bmin(3); inv_leaf = f32(1/leaf), a host
// scalar; coef = 15 int32.
#include "common.cuh"

#define VH_THREADS 256

template <bool NEAREST>
__global__ void __launch_bounds__(VH_THREADS)
voxel_head_exact_local(const int* __restrict__ local, int n,
                       const float* __restrict__ params, float inv_leaf,
                       const int* __restrict__ coeffs,
                       uint32_t* __restrict__ key_out,
                       uint32_t* __restrict__ rword_out) {
    __shared__ float p[18];
    __shared__ int coef[15];
    if (threadIdx.x < 18) p[threadIdx.x] = params[threadIdx.x];
    if (threadIdx.x >= 32 && threadIdx.x < 47)
        coef[threadIdx.x - 32] = coeffs[threadIdx.x - 32];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int l[3] = {local[3 * i + 0], local[3 * i + 1], local[3 * i + 2]};
    const float wx = (float)l[0] * p[0];
    const float wy = (float)l[1] * p[1];
    const float wz = (float)l[2] * p[2];
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float t = pt_affine_row(p + 3 + 3 * a, p[12 + a], wx, wy, wz);
        float u = (t - p[15 + a]) * inv_leaf;
        if (NEAREST) u = u - 0.5f;
        c[a] = (int)fminf(fmaxf(floorf(u), 0.0f), 1023.0f);
    }
    key_out[i] = pt_expand10((uint32_t)c[0]) | (pt_expand10((uint32_t)c[1]) << 1)
               | (pt_expand10((uint32_t)c[2]) << 2);
    uint32_t r[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const int d = l[a] - pt_cell_base(coef, c[0], c[1], c[2], a);
        r[a] = (uint32_t)min(max(d, 0), 1023);
    }
    rword_out[i] = (r[0] << 20) | (r[1] << 10) | r[2];
}

extern "C" int voxel_head_exact_local_launch(const void* local, int n,
                                             const void* params,
                                             float inv_leaf,
                                             const void* coeffs, int nearest,
                                             void* key, void* rword,
                                             void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + VH_THREADS - 1) / VH_THREADS;
    if (nearest)
        voxel_head_exact_local<true><<<blocks, VH_THREADS, 0, s>>>(
            (const int*)local, n, (const float*)params, inv_leaf,
            (const int*)coeffs,
            (uint32_t*)key, (uint32_t*)rword);
    else
        voxel_head_exact_local<false><<<blocks, VH_THREADS, 0, s>>>(
            (const int*)local, n, (const float*)params, inv_leaf,
            (const int*)coeffs,
            (uint32_t*)key, (uint32_t*)rword);
    return (int)cudaGetLastError();
}
