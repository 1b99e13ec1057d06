// K3 fused_sorted_voxel_reduce, in its three forms.
//
// Input: tile-sorted streams (Morton key, packed word, and the position
// operands of the form); a tile is tile_len consecutive rows sorted by
// (key, word) as unsigned.  A voxel is a run of equal valid keys inside one
// tile (valid: key != 0xFFFFFFFF; a tile start always opens a run).  Per
// voxel: point count, exact integer sums of each mean field packed in the
// word, run-length mode of the word's top mode_bits (longest run, then
// smallest value), field means cast back Rust-`as` style (trunc, clip)
// into the output word, and the centroid:
//
// VR_EXACT_LOCAL  residual word of three exact 10-bit local residuals:
//                 rot . ((cell_base(cell) + sum/count) * scale) + trans;
// VR_QUANTIZED    residual word of three q-bit in-cell residuals:
//                 (cell + (sum/count + 0.5) * scale_q) * leaf + bmin, the
//                 cell decoded from the key, scale_q = f32(window / 2^q);
// VR_EXACT_F32    three f32 position streams: their mean over the run,
//                 summed in f64 and rounded once.  Rows with the invalid key
//                 belong to no run, so whatever they hold (NaN included)
//                 contributes nothing.
//
// Launch 1 (count): voxels per tile.  The caller's exclusive cumsum of
// those counts gives each tile its global output offset.  Launch 2
// (write): one block per tile holds the tile in shared memory, a block-wide
// scan of the run-start flags ranks each voxel inside its tile, the thread
// that owns a run start walks that run (runs are a handful of points), and
// writes the voxel's row (centroid into the (N, 3) position tensor, word)
// at offsets[tile] + rank — globally compacted, no merge pass afterwards.
#include "common.cuh"

#define VR_THREADS 256
#define VR_MAX_FIELDS 4

#define VR_EXACT_LOCAL 0
#define VR_QUANTIZED 1
#define VR_EXACT_F32 2

struct VrFields {
    int n;
    int shift[VR_MAX_FIELDS];
    int width[VR_MAX_FIELDS];
    int is_signed[VR_MAX_FIELDS];
    float lo[VR_MAX_FIELDS];
    float hi[VR_MAX_FIELDS];
};

// inclusive block scan of one int per thread; returns the exclusive prefix
// and leaves the block total in *total
__device__ __forceinline__ int vr_block_exclusive_scan(int x, int* total) {
    __shared__ int warp_sums[VR_THREADS / 32];
    __shared__ int block_total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = x;
    for (int d = 1; d < 32; d <<= 1) {
        int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = (lane < VR_THREADS / 32) ? warp_sums[lane] : 0;
        int wi = w;
        for (int d = 1; d < VR_THREADS / 32; d <<= 1) {
            int y = __shfl_up_sync(0xFFFFFFFFu, wi, d);
            if (lane >= d) wi += y;
        }
        if (lane < VR_THREADS / 32) warp_sums[lane] = wi - w;
        if (lane == VR_THREADS / 32 - 1) block_total = wi;
    }
    __syncthreads();
    *total = block_total;
    return incl - x + warp_sums[warp];
}

__global__ void __launch_bounds__(VR_THREADS)
voxel_reduce_count(const uint32_t* __restrict__ key, int tile_len,
                   int* __restrict__ counts) {
    const uint32_t* k = key + (long long)blockIdx.x * tile_len;
    int c = 0;
    for (int i = threadIdx.x; i < tile_len; i += blockDim.x) {
        const uint32_t a = k[i];
        c += (a != PT_INVALID_KEY) && (i == 0 || a != k[i - 1]);
    }
    int total;
    vr_block_exclusive_scan(c, &total);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// params: VR_EXACT_LOCAL scale(3) rot(9) trans(3); VR_QUANTIZED bmin(3)
// leaf scale_q; VR_EXACT_F32 none.  s3 holds the residual word (first two
// forms) or the bits of px (third); s4, s5 the bits of py, pz.
template <int FORM>
__global__ void __launch_bounds__(VR_THREADS)
voxel_reduce_write(const uint32_t* __restrict__ key_in,
                   const uint32_t* __restrict__ word_in,
                   const uint32_t* __restrict__ s3_in,
                   const uint32_t* __restrict__ s4_in,
                   const uint32_t* __restrict__ s5_in, int tile_len,
                   const int* __restrict__ offsets,
                   const float* __restrict__ params,
                   const int* __restrict__ coeffs, int qbits, int mode_bits,
                   VrFields fields, float* __restrict__ pos,
                   uint32_t* __restrict__ out_word) {
    extern __shared__ uint32_t sm[];
    uint32_t* key = sm;
    uint32_t* word = sm + tile_len;
    uint32_t* rword = sm + 2 * tile_len;                 // or px
    const float* px = (const float*)(sm + 2 * tile_len);
    const float* py = (const float*)(sm + 3 * tile_len);
    const float* pz = (const float*)(sm + 4 * tile_len);
    __shared__ float p[15];
    __shared__ int coef[15];
    if (FORM == VR_EXACT_LOCAL && threadIdx.x < 15) {
        p[threadIdx.x] = params[threadIdx.x];
        coef[threadIdx.x] = coeffs[threadIdx.x];
    }
    if (FORM == VR_QUANTIZED && threadIdx.x < 5)
        p[threadIdx.x] = params[threadIdx.x];
    const long long base = (long long)blockIdx.x * tile_len;
    for (int i = threadIdx.x; i < tile_len; i += blockDim.x) {
        key[i] = key_in[base + i];
        word[i] = word_in[base + i];
        sm[2 * tile_len + i] = s3_in[base + i];
        if (FORM == VR_EXACT_F32) {
            sm[3 * tile_len + i] = s4_in[base + i];
            sm[4 * tile_len + i] = s5_in[base + i];
        }
    }
    __syncthreads();

    // each thread owns a contiguous chunk of rows
    const int per = (tile_len + VR_THREADS - 1) / VR_THREADS;
    const int begin = min(threadIdx.x * per, tile_len);
    const int end = min(begin + per, tile_len);
    int c = 0;
    for (int i = begin; i < end; ++i)
        c += (key[i] != PT_INVALID_KEY) && (i == 0 || key[i] != key[i - 1]);
    int total;
    int rank = vr_block_exclusive_scan(c, &total);
    const long long out_base = offsets[blockIdx.x];

    for (int i = begin; i < end; ++i) {
        const uint32_t k = key[i];
        if (k == PT_INVALID_KEY || (i != 0 && k == key[i - 1])) continue;
        // ---- walk the run that starts at row i ---------------------------
        int cnt = 0, s0 = 0, s1 = 0, s2 = 0;
        double d0 = 0.0, d1 = 0.0, d2 = 0.0;
        const int qsh = FORM == VR_EXACT_LOCAL ? 10 : qbits;
        const uint32_t qmask = (1u << qsh) - 1u;
        long long fs[VR_MAX_FIELDS] = {0, 0, 0, 0};
        uint32_t cur_val = 0, best_val = 0;
        int cur_len = 0, best_len = 0;
        for (int j = i; j < tile_len && key[j] == k; ++j) {
            const uint32_t w = word[j];
            ++cnt;
            if (FORM == VR_EXACT_F32) {
                d0 += (double)px[j];
                d1 += (double)py[j];
                d2 += (double)pz[j];
            } else {
                const uint32_t r = rword[j];
                s0 += (int)((r >> (2 * qsh)) & qmask);
                s1 += (int)((r >> qsh) & qmask);
                s2 += (int)(r & qmask);
            }
#pragma unroll
            for (int f = 0; f < VR_MAX_FIELDS; ++f) {
                if (f < fields.n) {
                    const int fw = fields.width[f];
                    const uint32_t mask =
                        fw >= 32 ? 0xFFFFFFFFu : ((1u << fw) - 1u);
                    long long v = (long long)((w >> fields.shift[f]) & mask);
                    if (fields.is_signed[f]) {
                        const long long sb = 1LL << (fw - 1);
                        v = (v ^ sb) - sb;
                    }
                    fs[f] += v;
                }
            }
            if (mode_bits) {
                const uint32_t mv = w >> (32 - mode_bits);
                if (cur_len > 0 && mv == cur_val) {
                    ++cur_len;
                } else {
                    cur_val = mv;
                    cur_len = 1;
                }
                if (cur_len > best_len
                    || (cur_len == best_len && cur_val < best_val)) {
                    best_len = cur_len;
                    best_val = cur_val;
                }
            }
        }
        const float cntf = (float)max(cnt, 1);
        uint32_t ow = 0;
        if (mode_bits) ow = best_val << (32 - mode_bits);
#pragma unroll
        for (int f = 0; f < VR_MAX_FIELDS; ++f) {
            if (f < fields.n) {
                const int fw = fields.width[f];
                const uint32_t mask =
                    fw >= 32 ? 0xFFFFFFFFu : ((1u << fw) - 1u);
                float t = truncf((float)fs[f] / cntf);
                t = fminf(fmaxf(t, fields.lo[f]), fields.hi[f]);
                ow |= ((uint32_t)(long long)t & mask) << fields.shift[f];
            }
        }
        const long long o = out_base + rank;
        if (FORM == VR_EXACT_F32) {
            const double cntd = (double)max(cnt, 1);
            pos[3 * o + 0] = (float)(d0 / cntd);
            pos[3 * o + 1] = (float)(d1 / cntd);
            pos[3 * o + 2] = (float)(d2 / cntd);
        } else {
            const int cx = (int)pt_compact10(k);
            const int cy = (int)pt_compact10(k >> 1);
            const int cz = (int)pt_compact10(k >> 2);
            const float m0 = (float)s0 / cntf, m1 = (float)s1 / cntf,
                        m2 = (float)s2 / cntf;
            if (FORM == VR_EXACT_LOCAL) {
                const float mlx =
                    ((float)pt_cell_base(coef, cx, cy, cz, 0) + m0) * p[0];
                const float mly =
                    ((float)pt_cell_base(coef, cx, cy, cz, 1) + m1) * p[1];
                const float mlz =
                    ((float)pt_cell_base(coef, cx, cy, cz, 2) + m2) * p[2];
                pos[3 * o + 0] = pt_affine_row(p + 3, p[12], mlx, mly, mlz);
                pos[3 * o + 1] = pt_affine_row(p + 6, p[13], mlx, mly, mlz);
                pos[3 * o + 2] = pt_affine_row(p + 9, p[14], mlx, mly, mlz);
            } else {
                pos[3 * o + 0] = ((float)cx + (m0 + 0.5f) * p[4]) * p[3] + p[0];
                pos[3 * o + 1] = ((float)cy + (m1 + 0.5f) * p[4]) * p[3] + p[1];
                pos[3 * o + 2] = ((float)cz + (m2 + 0.5f) * p[4]) * p[3] + p[2];
            }
        }
        out_word[o] = ow;
        ++rank;
    }
}

extern "C" int voxel_reduce_count_launch(const void* key, int tiles,
                                         int tile_len, void* counts,
                                         void* stream) {
    voxel_reduce_count<<<tiles, VR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)key, tile_len, (int*)counts);
    return (int)cudaGetLastError();
}

template <int FORM>
static int vr_launch_write(const void* key, const void* word, const void* s3,
                           const void* s4, const void* s5, int tiles,
                           int tile_len, const void* offsets,
                           const void* params, const void* coeffs, int qbits,
                           int mode_bits, const VrFields& f, void* pos,
                           void* out_word, cudaStream_t stream) {
    const int streams = FORM == VR_EXACT_F32 ? 5 : 3;
    const size_t smem = (size_t)streams * tile_len * sizeof(uint32_t);
    // the kernel also holds ~200 B of static shared memory, so opt in to
    // the large carve-out before the sum can pass the 48 KiB default
    if (smem > 40 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            voxel_reduce_write<FORM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    voxel_reduce_write<FORM><<<tiles, VR_THREADS, smem, stream>>>(
        (const uint32_t*)key, (const uint32_t*)word, (const uint32_t*)s3,
        (const uint32_t*)s4, (const uint32_t*)s5, tile_len,
        (const int*)offsets, (const float*)params, (const int*)coeffs, qbits,
        mode_bits, f, (float*)pos, (uint32_t*)out_word);
    return (int)cudaGetLastError();
}

// form: VR_EXACT_LOCAL (s3 the residual word, params of 15, coeffs),
// VR_QUANTIZED (s3 the residual word, params of 5, qbits) or VR_EXACT_F32
// (s3, s4, s5 the bits of px, py, pz).
extern "C" int voxel_reduce_write_launch(
    int form, const void* key, const void* word, const void* s3,
    const void* s4, const void* s5, int tiles, int tile_len,
    const void* offsets, const void* params, const void* coeffs, int qbits,
    int mode_bits, int n_fields, const void* field_ints,
    const void* field_floats, void* pos, void* out_word, void* stream) {
    if (n_fields < 0 || n_fields > VR_MAX_FIELDS || mode_bits < 0
        || mode_bits > 32)
        return (int)cudaErrorInvalidValue;
    if (form == VR_QUANTIZED && (qbits < 1 || 3 * qbits > 32))
        return (int)cudaErrorInvalidValue;
    VrFields f;
    f.n = n_fields;
    const int* fi = (const int*)field_ints;       // host: shift, width, signed
    const float* ff = (const float*)field_floats; // host: lo, hi
    for (int i = 0; i < VR_MAX_FIELDS; ++i) {
        const bool on = i < n_fields;
        f.shift[i] = on ? fi[3 * i + 0] : 0;
        f.width[i] = on ? fi[3 * i + 1] : 1;
        f.is_signed[i] = on ? fi[3 * i + 2] : 0;
        f.lo[i] = on ? ff[2 * i + 0] : 0.0f;
        f.hi[i] = on ? ff[2 * i + 1] : 0.0f;
    }
    cudaStream_t s = (cudaStream_t)stream;
#define VR_CASE(FORM) \
    case FORM: \
        return vr_launch_write<FORM>(key, word, s3, s4, s5, tiles, tile_len, \
                                     offsets, params, coeffs, qbits, \
                                     mode_bits, f, pos, out_word, s);
    switch (form) {
        VR_CASE(VR_EXACT_LOCAL) VR_CASE(VR_QUANTIZED) VR_CASE(VR_EXACT_F32)
    }
#undef VR_CASE
    return (int)cudaErrorInvalidValue;
}
