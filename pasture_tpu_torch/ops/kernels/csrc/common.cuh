// Shared device helpers of the pasture_tpu_torch kernels.
//
// All sources are compiled with -fmad=false: every float operation is
// rounded on its own, so a kernel equals its plain PyTorch version bit for
// bit.  u32 words arrive as 4-byte streams and are compared as unsigned.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define PT_INVALID_KEY 0xFFFFFFFFu
#define PT_BASE_SHIFT 8

__device__ __forceinline__ uint32_t pt_expand10(uint32_t v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    v = (v | (v << 2)) & 0x09249249u;
    return v;
}

__device__ __forceinline__ uint32_t pt_compact10(uint32_t v) {
    v &= 0x09249249u;
    v = (v | (v >> 2)) & 0x030C30C3u;
    v = (v | (v >> 4)) & 0x0300F00Fu;
    v = (v | (v >> 8)) & 0x030000FFu;
    v = (v | (v >> 16)) & 0x3FFu;
    return v;
}

// Integer fixed-point cell base of one axis: i32 arithmetic, arithmetic
// shift.  coef = M (9, row-major), C_hi (3), C_lo (3).
__device__ __forceinline__ int pt_cell_base(const int* coef, int cx, int cy,
                                            int cz, int axis) {
    const int* m = coef + 3 * axis;
    int acc = m[0] * cx + m[1] * cy + m[2] * cz + coef[12 + axis];
    return (acc >> PT_BASE_SHIFT) + coef[9 + axis] - 512;
}

// rot . w + trans for one output axis, left to right like the reference:
// ((r0*wx + r1*wy) + r2*wz) + t.
__device__ __forceinline__ float pt_affine_row(const float* rot, float t,
                                               float wx, float wy, float wz) {
    return rot[0] * wx + rot[1] * wy + rot[2] * wz + t;
}
