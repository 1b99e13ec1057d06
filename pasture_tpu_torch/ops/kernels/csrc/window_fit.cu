// K6 window_fit_moments: per query, the k nearest of its +-w Morton-window
// candidates, then the moments of that neighbourhood in the query's frame.
//
// Replaces pasture_tpu/ops/kernels/window_fit_kernel.py
// window_fit_moments_pallas (_make_kernel).  The TPU kernel carries three
// block views of the candidate stream and rolls lanes and rows to form each
// shift; here a block of WF_THREADS queries copies its candidate strip,
// rows [b * WF_THREADS, b * WF_THREADS + WF_THREADS + 2w) of pp, into
// shared memory once (as three SoA float arrays, inf past the end) and
// thread t reads shift s at strip row t + w + s: neighbouring threads read
// neighbouring words, no bank conflicts, no rolls.
//
// Bound on the H100: operations, not bytes.  Per query and shift, pass 1
// takes 8 float operations for d2 and k min + k max to bubble it through k
// sorted registers; pass 2 takes ~30 (d2 again, the selection, 11
// accumulators).  At n = 2 097 152, k = 12, w = 64 that is ~17 G operations
// against ~143 MB moved.  The design keeps everything a query touches in
// registers and shared memory: the k registers are a local array fully
// unrolled to a compile-time KMAX (instances 8, 16, 32, the runtime k <=
// KMAX; the k smallest of KMAX sorted registers are the k smallest), the
// strip is read from device memory once per block.
//
// Numerics: built with -fmad=false like every source here, and both passes
// compute d2 by one expression, ((dx*dx + dy*dy) + dz*dz), so the
// threshold test agrees with the stored k-th distance and the kernel equals
// window_fit_moments_plain bit for bit.  The (1 + 1e-6) margin on the k-th
// distance is the TPU kernel's and sets which near-ties are admitted.
#include "common.cuh"

#define WF_THREADS 256
#define WF_FIN 3.0e38f        // finite-candidate guard (inf marks padding)
#define WF_MARGIN 1.000001f   // float32(1 + 1e-6)

template <int KMAX>
__global__ void __launch_bounds__(WF_THREADS)
window_fit_moments(const float* __restrict__ sp, const float* __restrict__ pp,
                   int n, int k, int w, float* __restrict__ cnt,
                   float* __restrict__ tight, float* __restrict__ s,
                   float* __restrict__ m6) {
    extern __shared__ float strip[];
    const int len = WF_THREADS + 2 * w;
    const float* cx = strip;
    const float* cy = strip + len;
    const float* cz = strip + 2 * len;
    const long long row0 = (long long)blockIdx.x * WF_THREADS;
    const long long rows = (long long)n + 2 * w;
    const float inf = __int_as_float(0x7f800000);
    for (int e = threadIdx.x; e < 3 * len; e += WF_THREADS) {
        const int r = e / 3, a = e - 3 * r;
        strip[a * len + r] = row0 + r < rows ? pp[3 * row0 + e] : inf;
    }
    __syncthreads();
    const int t = threadIdx.x;
    const long long i = row0 + t;
    if (i >= n) return;
    const float qx = sp[3 * i], qy = sp[3 * i + 1], qz = sp[3 * i + 2];
    const int shifts = 2 * w + 1;

    // pass 1: the k smallest d2 of the window, sorted, in registers
    float regs[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) regs[r] = inf;
    for (int j = 0; j < shifts; ++j) {
        const float dx = cx[t + j] - qx;
        const float dy = cy[t + j] - qy;
        const float dz = cz[t + j] - qz;
        float v = dx * dx + dy * dy + dz * dz;
#pragma unroll
        for (int r = 0; r < KMAX; ++r) {
            const float lo = fminf(regs[r], v);
            v = fmaxf(regs[r], v);
            regs[r] = lo;
        }
    }
    float kth = regs[0];
#pragma unroll
    for (int r = 1; r < KMAX; ++r)
        if (r == k - 1) kth = regs[r];
    const float thr = kth * WF_MARGIN;

    // pass 2: count, tightness and query-frame moments of the selection
    float c = 0.f, tg = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float xx = 0.f, yy = 0.f, zz = 0.f, xy = 0.f, xz = 0.f, yz = 0.f;
    for (int j = 0; j < shifts; ++j) {
        const float px = cx[t + j];
        const float dx = px - qx;
        const float dy = cy[t + j] - qy;
        const float dz = cz[t + j] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const bool sel = (d2 <= thr) && (px <= WF_FIN);
        c = c + (sel ? 1.f : 0.f);
        tg = tg + (sel ? d2 : 0.f);
        const float ex = sel ? dx : 0.f;
        const float ey = sel ? dy : 0.f;
        const float ez = sel ? dz : 0.f;
        s0 = s0 + ex;
        s1 = s1 + ey;
        s2 = s2 + ez;
        xx = xx + ex * ex;
        yy = yy + ey * ey;
        zz = zz + ez * ez;
        xy = xy + ex * ey;
        xz = xz + ex * ez;
        yz = yz + ey * ez;
    }
    cnt[i] = c;
    tight[i] = tg;
    s[3 * i] = s0;
    s[3 * i + 1] = s1;
    s[3 * i + 2] = s2;
    float* m = m6 + 6 * i;
    m[0] = xx;
    m[1] = yy;
    m[2] = zz;
    m[3] = xy;
    m[4] = xz;
    m[5] = yz;
}

// sp: (n, 3) f32 queries; pp: (n + 2w, 3) f32 candidates, inf where invalid;
// outputs cnt (n,), tight (n,), s (n, 3), m6 (n, 6) f32.  The strip must
// fit the default 48 KB of shared memory: 12 * (WF_THREADS + 2w) bytes.
extern "C" int window_fit_launch(const void* sp, const void* pp, int n, int k,
                                 int w, void* cnt, void* tight, void* s,
                                 void* m6, void* stream) {
    const size_t smem = (size_t)3 * (WF_THREADS + 2 * w) * sizeof(float);
    if (n <= 0 || k < 1 || k > 32 || w < 1 || smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    const int blocks = (int)(((long long)n + WF_THREADS - 1) / WF_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    const float* q = (const float*)sp;
    const float* c = (const float*)pp;
    float *o0 = (float*)cnt, *o1 = (float*)tight, *o2 = (float*)s,
          *o3 = (float*)m6;
    if (k <= 8)
        window_fit_moments<8><<<blocks, WF_THREADS, smem, st>>>(
            q, c, n, k, w, o0, o1, o2, o3);
    else if (k <= 16)
        window_fit_moments<16><<<blocks, WF_THREADS, smem, st>>>(
            q, c, n, k, w, o0, o1, o2, o3);
    else
        window_fit_moments<32><<<blocks, WF_THREADS, smem, st>>>(
            q, c, n, k, w, o0, o1, o2, o3);
    return (int)cudaGetLastError();
}
