// The three voxel heads.  Each, per point: decode + rotate + translate,
// u = (t - bmin) * inv_leaf, cell = clip(floor(u [- 0.5 for nearest]), 0,
// 1023), 30-bit Morton key; and beside the key
//
// K2  fused_voxel_head_exact_local: the word rx<<20 | ry<<10 | rz of the
//     exact 10-bit residuals r = clip(local - cell_base(coef, cell), 0, 1023);
// K7a fused_voxel_head: the word qx<<2q | qy<<q | qz of the q-bit residuals
//     q = clip(floor((u - cell) * qscale), 0, 2^q - 1), u - cell taken after
//     the clip of the cell, so a point beyond the grid saturates;
// K7b fused_decode_transform_key: the world position t itself, as one row
//     of an (N, 3) tensor (floor semantics only).
//
// One thread per point; the (N, 3) int32 tensor is read as it is.
// params = scale(3) rot(9) trans(3) bmin(3); inv_leaf = f32(1/leaf) and
// qscale = f32(2^q / window) are host scalars; coef = 15 int32.
#include "common.cuh"

#define VH_THREADS 256

// world position t[3] and grid coordinate u[3] of point i
__device__ __forceinline__ void vh_world(const int* __restrict__ local,
                                         long long i, const float* p,
                                         float inv_leaf, int l[3], float t[3],
                                         float u[3]) {
    l[0] = local[3 * i + 0];
    l[1] = local[3 * i + 1];
    l[2] = local[3 * i + 2];
    const float wx = (float)l[0] * p[0];
    const float wy = (float)l[1] * p[1];
    const float wz = (float)l[2] * p[2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        t[a] = pt_affine_row(p + 3 + 3 * a, p[12 + a], wx, wy, wz);
        u[a] = (t[a] - p[15 + a]) * inv_leaf;
    }
}

template <bool NEAREST>
__device__ __forceinline__ int vh_cell(float u) {
    if (NEAREST) u = u - 0.5f;
    return (int)fminf(fmaxf(floorf(u), 0.0f), 1023.0f);
}

__device__ __forceinline__ uint32_t vh_key(const int c[3]) {
    return pt_expand10((uint32_t)c[0]) | (pt_expand10((uint32_t)c[1]) << 1)
         | (pt_expand10((uint32_t)c[2]) << 2);
}

template <bool NEAREST>
__global__ void __launch_bounds__(VH_THREADS)
voxel_head_quantized(const int* __restrict__ local, int n,
                     const float* __restrict__ params, float inv_leaf,
                     float qscale, int qbits, uint32_t* __restrict__ key_out,
                     uint32_t* __restrict__ qword_out) {
    __shared__ float p[18];
    if (threadIdx.x < 18) p[threadIdx.x] = params[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int l[3], c[3];
    float t[3], u[3];
    vh_world(local, i, p, inv_leaf, l, t, u);
    const float qmax = (float)((1 << qbits) - 1);
    uint32_t q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        c[a] = vh_cell<NEAREST>(u[a]);
        const float r = (u[a] - (float)c[a]) * qscale;
        q[a] = (uint32_t)(int)fminf(fmaxf(floorf(r), 0.0f), qmax);
    }
    key_out[i] = vh_key(c);
    qword_out[i] = (q[0] << (2 * qbits)) | (q[1] << qbits) | q[2];
}

__global__ void __launch_bounds__(VH_THREADS)
decode_transform_key(const int* __restrict__ local, int n,
                     const float* __restrict__ params, float inv_leaf,
                     float* __restrict__ world_out,
                     uint32_t* __restrict__ key_out) {
    __shared__ float p[18];
    if (threadIdx.x < 18) p[threadIdx.x] = params[threadIdx.x];
    __syncthreads();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int l[3], c[3];
    float t[3], u[3];
    vh_world(local, i, p, inv_leaf, l, t, u);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        c[a] = vh_cell<false>(u[a]);
        world_out[3 * i + a] = t[a];
    }
    key_out[i] = vh_key(c);
}

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
    int l[3], c[3];
    float t[3], u[3];
    vh_world(local, i, p, inv_leaf, l, t, u);
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = vh_cell<NEAREST>(u[a]);
    key_out[i] = vh_key(c);
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

extern "C" int voxel_head_quantized_launch(const void* local, int n,
                                           const void* params, float inv_leaf,
                                           float qscale, int qbits,
                                           int nearest, void* key, void* qword,
                                           void* stream) {
    if (qbits < 1 || 3 * qbits > 32) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int blocks = (n + VH_THREADS - 1) / VH_THREADS;
    if (nearest)
        voxel_head_quantized<true><<<blocks, VH_THREADS, 0, s>>>(
            (const int*)local, n, (const float*)params, inv_leaf, qscale,
            qbits, (uint32_t*)key, (uint32_t*)qword);
    else
        voxel_head_quantized<false><<<blocks, VH_THREADS, 0, s>>>(
            (const int*)local, n, (const float*)params, inv_leaf, qscale,
            qbits, (uint32_t*)key, (uint32_t*)qword);
    return (int)cudaGetLastError();
}

extern "C" int decode_transform_key_launch(const void* local, int n,
                                           const void* params, float inv_leaf,
                                           void* world, void* key,
                                           void* stream) {
    const int blocks = (n + VH_THREADS - 1) / VH_THREADS;
    decode_transform_key<<<blocks, VH_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)local, n, (const float*)params, inv_leaf, (float*)world,
        (uint32_t*)key);
    return (int)cudaGetLastError();
}
