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
// One launch, one pass over the input (Hopper design).  A warp owns a
// chunk: the whole tiles that fit VR_CHUNK rows (one tile when tiles are
// longer).  It stages the chunk's streams in shared memory with 16-byte
// asynchronous copies, then walks the chunk 32 rows at a time, row
// 32m + lane in lane `lane`: a ballot of the run-start flags gives every
// voxel its rank in the chunk (the ballots before it, then the lanes below
// it).  The CTA's chunks (up to VR_CTA_ROWS rows) add their voxel counts
// in shared memory, and the CTA's count goes through the decoupled
// look-back of scan.cuh (CTAs numbered by ticket), which gives each chunk
// its global output offset (a unit of a CTA, not of a warp, keeps the
// look-back's chain short).  A second walk over the same ballots: the lane
// holding a run's start follows the run through shared memory, into later
// lanes' and later rounds' rows, and writes the voxel's row at offset +
// rank, so the rows of one round land side by side.  The last CTA writes
// the voxel count; a second small launch zeroes the rows at or past it, so
// no output row is written twice.
//
// Integer field sums are 32-bit where the host has proved that
// width + ceil(log2(tile_len)) <= 31 (the WIDE template flag off), else
// 64-bit; either is exact, and the mean is f32(sum) / f32(count) as in the
// plain version.  Bound: bytes (each input row read once, each output row
// written once).
#include <cuda_pipeline.h>

#include "common.cuh"
#include "scan.cuh"

#define VR_MAX_FIELDS 4
#define VR_CHUNK 512            // rows of a warp's chunk of whole tiles
#define VR_CTA_ROWS 4096        // rows a CTA stages: up to 8 warps

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

struct VrShape {
    int tile_len, tiles;
    int chunk_tiles, chunks;
    int ctas;           // the look-back's units
    int stream_words;   // one stream of a warp's region: a chunk, rounded to 4
    int warp_words;     // a warp's region: the streams, then one ballot per 32 rows
};

template <bool WIDE> struct VrAcc { typedef int T; };
template <> struct VrAcc<true> { typedef long long T; };

// row % tile_len of the row 32 further on
__device__ __forceinline__ int vr_next_rem(int rem, int tile_len) {
    rem += 32;
    if (rem >= tile_len)
        rem = tile_len >= 32 ? rem - tile_len : rem % tile_len;
    return rem;
}

// a / c from inv = 1 / c: the product, corrected by its residual (one f64
// division a voxel in place of three)
__device__ __forceinline__ double vr_div(double a, double c, double inv) {
    const double q = a * inv;
    return fma(fma(-q, c, a), inv, q);
}

// Rows [0, rows) of one stream into shared memory: 16-byte asynchronous
// copies while the stream is 16-byte aligned there, 4-byte loads after.
__device__ __forceinline__ void vr_stage(uint32_t* dst,
                                         const uint32_t* __restrict__ src,
                                         int rows, int lane) {
    int done = 0;
    if ((((uintptr_t)src) & 15) == 0) {
        const int vec = rows >> 2;
        for (int i = lane; i < vec; i += 32)
            __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
        done = vec << 2;
    }
    for (int i = done + lane; i < rows; i += 32) dst[i] = src[i];
}

// params: VR_EXACT_LOCAL scale(3) rot(9) trans(3); VR_QUANTIZED bmin(3)
// leaf scale_q; VR_EXACT_F32 none.  s3 holds the residual word (first two
// forms) or the bits of px (third); s4, s5 the bits of py, pz.
template <int FORM, bool WIDE>
__global__ void __launch_bounds__(VR_CTA_ROWS / VR_CHUNK * 32)
voxel_reduce(const uint32_t* __restrict__ key_in,
             const uint32_t* __restrict__ word_in,
             const uint32_t* __restrict__ s3_in,
             const uint32_t* __restrict__ s4_in,
             const uint32_t* __restrict__ s5_in, VrShape sh,
             const float* __restrict__ params,
             const int* __restrict__ coeffs, int qbits, int mode_bits,
             VrFields fields, unsigned long long* __restrict__ status,
             int* __restrict__ count, float* __restrict__ pos,
             uint32_t* __restrict__ out_word) {
    constexpr int S = FORM == VR_EXACT_F32 ? 5 : 3;
    typedef typename VrAcc<WIDE>::T Acc;
    extern __shared__ __align__(16) uint32_t vr_sm[];
    __shared__ float p[15];
    __shared__ int coef[15];
    __shared__ int ticket;
    __shared__ int warp_base[VR_CTA_ROWS / VR_CHUNK];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    if (threadIdx.x == 0) ticket = (int)atomicAdd(status, 1ull);
    if (FORM == VR_EXACT_LOCAL && threadIdx.x < 15) {
        p[threadIdx.x] = params[threadIdx.x];
        coef[threadIdx.x] = coeffs[threadIdx.x];
    }
    if (FORM == VR_QUANTIZED && threadIdx.x < 5)
        p[threadIdx.x] = params[threadIdx.x];
    __syncthreads();
    const int cta = ticket;
    const long long chunk = (long long)cta * warps + warp;
    const int tile_len = sh.tile_len;
    const long long tile0 = chunk * sh.chunk_tiles;
    // a warp past the last chunk has no rows, but keeps the CTA's barriers
    const int rows = chunk >= sh.chunks ? 0
                   : (int)(sh.tiles - tile0 < sh.chunk_tiles
                               ? sh.tiles - tile0 : sh.chunk_tiles) * tile_len;
    const long long row0 = tile0 * tile_len;
    uint32_t* region = vr_sm + warp * sh.warp_words;
    const uint32_t* srcs[5] = {key_in, word_in, s3_in, s4_in, s5_in};
    if (rows > 0) {
#pragma unroll
        for (int s = 0; s < S; ++s)
            vr_stage(region + s * sh.stream_words, srcs[s] + row0, rows,
                     lane);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const uint32_t* key = region;
    const uint32_t* word = region + sh.stream_words;
    const uint32_t* rword = region + 2 * sh.stream_words;
    const float* px = (const float*)(region + 2 * sh.stream_words);
    const float* py = (const float*)(region + 3 * sh.stream_words);
    const float* pz = (const float*)(region + 4 * sh.stream_words);
    uint32_t* bal = region + S * sh.stream_words;
    const int rounds = (rows + 31) >> 5;

    // walk 1: the run starts, one ballot per round of 32 rows
    int total = 0;
    int rem = lane % tile_len;
    for (int m = 0; m < rounds; ++m) {
        const int r = (m << 5) + lane;
        bool start = false;
        if (r < rows) {
            const uint32_t k = key[r];
            start = k != PT_INVALID_KEY && (rem == 0 || k != key[r - 1]);
        }
        const uint32_t b = __ballot_sync(PT_FULL_MASK, start);
        if (lane == 0) bal[m] = b;
        total += __popc(b);
        rem = vr_next_rem(rem, tile_len);
    }
    // the CTA's count, its look-back, each chunk's offset
    if (lane == 0) warp_base[warp] = total;
    __syncthreads();
    if (warp == 0) {
        const int own = lane < warps ? warp_base[lane] : 0;
        int incl = own;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(PT_FULL_MASK, incl, d);
            if (lane >= d) incl += y;
        }
        const int excl = pt_publish_and_look_back(
            status + 1, cta, sh.ctas, __shfl_sync(PT_FULL_MASK, incl, 31),
            count, lane);
        if (lane < warps) warp_base[lane] = excl + incl - own;
    }
    __syncthreads();
    if (rows == 0) return;
    int base = warp_base[warp];

    // walk 2: the lane holding a run's start reduces the run
    const int qsh = FORM == VR_EXACT_LOCAL ? 10 : qbits;
    const uint32_t qmask = (1u << qsh) - 1u;
    rem = lane % tile_len;
    for (int m = 0; m < rounds; ++m) {
        const uint32_t b = bal[m];
        if ((b >> lane) & 1u) {
            const int i = (m << 5) + lane;
            const int end = i - rem + tile_len;     // the run's tile ends here
            const uint32_t k = key[i];
            int cnt = 0, s0 = 0, s1 = 0, s2 = 0;
            double d0 = 0.0, d1 = 0.0, d2 = 0.0;
            Acc fs[VR_MAX_FIELDS] = {0, 0, 0, 0};
            uint32_t cur_val = 0, best_val = 0;
            int cur_len = 0, best_len = 0;
            for (int j = i; j < end && key[j] == k; ++j) {
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
                        Acc v = (Acc)((w >> fields.shift[f]) & mask);
                        if (fields.is_signed[f]) {
                            const Acc sb = (Acc)1 << (fw - 1);
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
            const float cntf = (float)cnt;
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
                    ow |= ((uint32_t)(Acc)t & mask) << fields.shift[f];
                }
            }
            const long long o =
                base + __popc(b & ((1u << lane) - 1u));
            float* __restrict__ row = pos + 3 * o;
            if (FORM == VR_EXACT_F32) {
                const double cntd = (double)cnt, inv = 1.0 / cntd;
                row[0] = (float)vr_div(d0, cntd, inv);
                row[1] = (float)vr_div(d1, cntd, inv);
                row[2] = (float)vr_div(d2, cntd, inv);
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
                    row[0] = pt_affine_row(p + 3, p[12], mlx, mly, mlz);
                    row[1] = pt_affine_row(p + 6, p[13], mlx, mly, mlz);
                    row[2] = pt_affine_row(p + 9, p[14], mlx, mly, mlz);
                } else {
                    row[0] = ((float)cx + (m0 + 0.5f) * p[4]) * p[3] + p[0];
                    row[1] = ((float)cy + (m1 + 0.5f) * p[4]) * p[3] + p[1];
                    row[2] = ((float)cz + (m2 + 0.5f) * p[4]) * p[3] + p[2];
                }
            }
            out_word[o] = ow;
        }
        base += __popc(b);
        rem = vr_next_rem(rem, tile_len);
    }
}

template <int FORM, bool WIDE>
static int vr_launch(const void* key, const void* word, const void* s3,
                     const void* s4, const void* s5, const VrShape& sh,
                     int warps, const void* params, const void* coeffs,
                     int qbits, int mode_bits, const VrFields& f,
                     void* status, void* count, void* pos, void* out_word,
                     cudaStream_t stream) {
    const size_t smem = (size_t)warps * sh.warp_words * sizeof(uint32_t);
    // the kernel also holds ~130 B of static shared memory, so opt in to
    // the large carve-out before the sum can pass the 48 KiB default
    if (smem > 40 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            voxel_reduce<FORM, WIDE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    voxel_reduce<FORM, WIDE><<<sh.ctas, 32 * warps, smem, stream>>>(
            (const uint32_t*)key, (const uint32_t*)word, (const uint32_t*)s3,
            (const uint32_t*)s4, (const uint32_t*)s5, sh,
            (const float*)params, (const int*)coeffs, qbits, mode_bits, f,
            (unsigned long long*)status, (int*)count, (float*)pos,
            (uint32_t*)out_word);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    PtTail t;
    t.ptr[0] = (char*)pos;
    t.row_bytes[0] = t.pitch[0] = 3 * sizeof(float);
    t.ptr[1] = (char*)out_word;
    t.row_bytes[1] = t.pitch[1] = sizeof(uint32_t);
    return (int)pt_launch_zero_tail(t, 2, (const int*)count,
                                    (long long)sh.tiles * sh.tile_len, stream);
}

// form: VR_EXACT_LOCAL (s3 the residual word, params of 15, coeffs),
// VR_QUANTIZED (s3 the residual word, params of 5, qbits) or VR_EXACT_F32
// (s3, s4, s5 the bits of px, py, pz).  wide: 64-bit field sums.  chunks:
// the caller's count of chunks, which sized status to chunks + 1 zeroed
// int64 words (the ticket, then a status word per CTA: there are at most
// as many CTAs as chunks).  count: an int32 the kernel sets to the voxel
// count.
extern "C" int voxel_reduce_launch(
    int form, int wide, const void* key, const void* word, const void* s3,
    const void* s4, const void* s5, int tiles, int tile_len, int chunks,
    void* status, void* count, const void* params, const void* coeffs,
    int qbits, int mode_bits, int n_fields, const void* field_ints,
    const void* field_floats, void* pos, void* out_word, void* stream) {
    if (tiles < 1 || tile_len < 1 || tile_len > 4096
        || (long long)tiles * tile_len >= (1LL << 31) || n_fields < 0
        || n_fields > VR_MAX_FIELDS || mode_bits < 0 || mode_bits > 32)
        return (int)cudaErrorInvalidValue;
    if (form == VR_QUANTIZED && (qbits < 1 || 3 * qbits > 32))
        return (int)cudaErrorInvalidValue;
    VrShape sh;
    sh.tile_len = tile_len;
    sh.tiles = tiles;
    sh.chunk_tiles = tile_len <= VR_CHUNK ? VR_CHUNK / tile_len : 1;
    sh.chunks = (tiles + sh.chunk_tiles - 1) / sh.chunk_tiles;
    if (sh.chunks != chunks) return (int)cudaErrorInvalidValue;
    const int crow = sh.chunk_tiles * tile_len;
    const int streams = form == VR_EXACT_F32 ? 5 : 3;
    sh.stream_words = (crow + 3) & ~3;
    sh.warp_words = streams * sh.stream_words + ((((crow + 31) >> 5) + 3) & ~3);
    int warps = VR_CTA_ROWS / crow;
    warps = warps < 1 ? 1 : warps > VR_CTA_ROWS / VR_CHUNK
                                ? VR_CTA_ROWS / VR_CHUNK : warps;
    sh.ctas = (sh.chunks + warps - 1) / warps;
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
        return wide ? vr_launch<FORM, true>(key, word, s3, s4, s5, sh, warps, \
                                            params, coeffs, qbits, mode_bits, \
                                            f, status, count, pos, out_word, \
                                            s) \
                    : vr_launch<FORM, false>(key, word, s3, s4, s5, sh, \
                                             warps, params, coeffs, qbits, \
                                             mode_bits, f, status, count, \
                                             pos, out_word, s);
    switch (form) {
        VR_CASE(VR_EXACT_LOCAL) VR_CASE(VR_QUANTIZED) VR_CASE(VR_EXACT_F32)
    }
#undef VR_CASE
    return (int)cudaErrorInvalidValue;
}
