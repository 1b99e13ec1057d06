// K6 window_fit_moments: per query, the k nearest of its +-w Morton-window
// candidates, then the moments of that neighbourhood in the query's frame.
//
// Replaces pasture_tpu/ops/kernels/window_fit_kernel.py
// window_fit_moments_pallas (_make_kernel).  The TPU kernel carries three
// block views of the candidate stream and rolls lanes and rows to form each
// shift; here a block copies its candidate strip into shared memory once
// and every thread reads its shifts from there.
//
// Bound on the H100: instruction issue and its latency, not bytes.  The
// work the result needs is, per query and shift, d2 (8 float operations)
// and one compare in each pass, plus the k registers' fill and ~20
// operations per selected candidate.  The first design (one query a
// thread, every candidate bubbled through 16 registers, every candidate
// accumulated under a select) issued ~80 instructions per query and shift,
// most of them on work the result does not need.  This design cuts that
// three ways:
//
// 1. Two neighbouring queries a thread share the three shared-memory loads
//    of every candidate row: strip row 2t + j is shift j of query 2t and
//    shift j - 1 of query 2t + 1.  The strip is stored as two phases per
//    coordinate (row r at phase r % 2, index r / 2), so at a given j the
//    lanes of a warp read consecutive words: no bank conflicts.  (Four
//    queries a thread need more registers and ran slower in the design
//    runs: the kernel is bound by latency as much as by issue, and wants
//    warps.)
// 2. Pass 1 keeps exactly k sorted registers (one instance per k, 1..32)
//    and visits the rows centre-out, the Morton-nearest first, two rows a
//    step.  A candidate v enters only where v < regs[k-1]: a v at or above
//    the k-th smallest so far leaves the multiset of the k smallest
//    unchanged, and that multiset, so the k-th value, does not depend on
//    the order of the visits.  The warp votes: the insertion (new[r] =
//    min(old[r], max(old[r-1], v)), parallel, branch-free) runs only when
//    some lane needs it, and is the identity for the lanes that do not.
//    With 32 lanes of different queries some lane still needs most rows,
//    so the insertions remain the largest cost.
// 3. Pass 2 keeps the plain version's ascending shift order (the order of
//    the sums fixes their rounding).  It scans the rows in chunks of 64,
//    recomputing d2 by the same expression and collecting the selected
//    rows in a per-query bit mask, then walks the set bits in ascending
//    order and runs the 11 accumulators on those rows only.  Exact by
//    signed zeros: every accumulator starts at +0.0; in round-to-nearest
//    a + b is -0.0 only when a and b both are, so no accumulator is ever
//    -0.0, and the plain version's term for an unselected candidate,
//    +0.0 (torch.where(sel, x, 0)), leaves every accumulator unchanged.
//
// Numerics: built with -fmad=false like every source here, and both passes
// compute d2 by one expression, ((dx*dx + dy*dy) + dz*dz), so the
// threshold test agrees with the stored k-th distance and the kernel equals
// window_fit_moments_plain bit for bit.  d2 is never -0.0 or NaN (squares
// of finite or infinite offsets of a finite query), so min and max pick
// bit-identical values whatever the order.  The (1 + 1e-6) margin on the
// k-th distance is the TPU kernel's and sets which near-ties are admitted.
//
// nvcc -Xptxas -v with the build's flags (CUDA 12.8, sm_90a): 61 registers
// at k = 10 and 12, 0 bytes of stack and spills, 1 barrier.
#include "common.cuh"

#define WF_THREADS 128
#define WF_Q 2                // queries a thread
#define WF_FIN 3.0e38f        // finite-candidate guard (inf marks padding)
#define WF_MARGIN 1.000001f   // float32(1 + 1e-6)
#define WF_CHUNK 64           // rows a pass-2 bit mask covers
#define WF_FULL 0xffffffffu

// the strip: coordinate a, phase p at strip[(2a + p) * pl + index]
struct Strip {
    const float* s;
    int pl;
    int t;
    __device__ __forceinline__ void get(int j, float& x, float& y,
                                        float& z) const {
        const int o = (j & 1) * pl + t + (j >> 1);
        x = s[o];
        y = s[2 * pl + o];
        z = s[4 * pl + o];
    }
};

// insert v into the K sorted registers r (the largest drops out); the
// identity where v >= r[K-1]
template <int K>
__device__ __forceinline__ void insert(float (&r)[K], float v) {
#pragma unroll
    for (int i = K - 1; i > 0; --i) r[i] = fminf(r[i], fmaxf(r[i - 1], v));
    r[0] = fminf(r[0], v);
}

// d2 of the row (x, y, z) for the thread's two queries; inf where the row
// is not in the query's window (shift j - q outside [0, 2w]) or is no row
// at all (!ok)
__device__ __forceinline__ void offer(float x, float y, float z, int j,
                                      bool ok, int w2,
                                      const float (&qx)[WF_Q],
                                      const float (&qy)[WF_Q],
                                      const float (&qz)[WF_Q],
                                      float (&v)[WF_Q]) {
    const float inf = __int_as_float(0x7f800000);
#pragma unroll
    for (int q = 0; q < WF_Q; ++q) {
        const float dx = x - qx[q];
        const float dy = y - qy[q];
        const float dz = z - qz[q];
        const float d2 = dx * dx + dy * dy + dz * dz;
        v[q] = ok && (unsigned)(j - q) <= (unsigned)w2 ? d2 : inf;
    }
}

// pass 1: v[q] enters query q's K registers where some lane needs it (the
// votes first, so that the chains above them issue back to back)
template <int K>
__device__ __forceinline__ void enter(const float (&v)[WF_Q],
                                      float (&regs)[WF_Q][K]) {
    bool need[WF_Q];
#pragma unroll
    for (int q = 0; q < WF_Q; ++q)
        need[q] = __any_sync(WF_FULL, v[q] < regs[q][K - 1]);
#pragma unroll
    for (int q = 0; q < WF_Q; ++q)
        if (need[q]) insert<K>(regs[q], v[q]);
}

template <int K>
__global__ void __launch_bounds__(WF_THREADS)
window_fit_moments(const float* __restrict__ sp, const float* __restrict__ pp,
                   int n, int w, float* __restrict__ cnt,
                   float* __restrict__ tight, float* __restrict__ s,
                   float* __restrict__ m6) {
    extern __shared__ float strip[];
    const int len = WF_Q * WF_THREADS + 2 * w;
    const int pl = (len + 1) / 2;
    const long long row0 = (long long)blockIdx.x * (WF_Q * WF_THREADS);
    const long long rows = (long long)n + 2 * w;
    const float inf = __int_as_float(0x7f800000);
    for (int e = threadIdx.x; e < 3 * len; e += WF_THREADS) {
        const int r = e / 3, a = e - 3 * r;
        strip[(2 * a + (r & 1)) * pl + (r >> 1)] =
            row0 + r < rows ? pp[3 * row0 + e] : inf;
    }
    __syncthreads();
    // every thread stays to the end (the votes need whole warps); queries
    // past n compute on query 0's position and store nothing
    const int t = threadIdx.x;
    const Strip st{strip, pl, t};
    const long long i0 = row0 + (long long)WF_Q * t;
    float qx[WF_Q], qy[WF_Q], qz[WF_Q];
#pragma unroll
    for (int q = 0; q < WF_Q; ++q) {
        const long long i = i0 + q < n ? i0 + q : 0;
        qx[q] = sp[3 * i];
        qy[q] = sp[3 * i + 1];
        qz[q] = sp[3 * i + 2];
    }
    const int w2 = 2 * w;
    const int span = w2 + WF_Q;   // rows j = q + shift, shift in [0, 2w]

    // pass 1: the K smallest d2 of each query's window, sorted; rows
    // centre-out, two a step: c + d and c - 1 - d
    float regs[WF_Q][K];
#pragma unroll
    for (int q = 0; q < WF_Q; ++q)
#pragma unroll
        for (int r = 0; r < K; ++r) regs[q][r] = inf;
    const int c = span >> 1;
    for (int d = 0; d < span - c; ++d) {
        const int ja = c + d, jb = c - 1 - d;
        const bool okb = jb >= 0;
        float xa, ya, za, xb, yb, zb, va[WF_Q], vb[WF_Q];
        st.get(ja, xa, ya, za);
        st.get(okb ? jb : ja, xb, yb, zb);
        offer(xa, ya, za, ja, true, w2, qx, qy, qz, va);
        offer(xb, yb, zb, jb, okb, w2, qx, qy, qz, vb);
        enter<K>(va, regs);
        enter<K>(vb, regs);
    }
    float thr[WF_Q];
#pragma unroll
    for (int q = 0; q < WF_Q; ++q) thr[q] = regs[q][K - 1] * WF_MARGIN;

    // pass 2: count, tightness and query-frame moments of the selection,
    // in ascending shift order, selected rows only
    float acc[WF_Q][11];
#pragma unroll
    for (int q = 0; q < WF_Q; ++q)
#pragma unroll
        for (int a = 0; a < 11; ++a) acc[q][a] = 0.f;
    for (int j0 = 0; j0 < span; j0 += WF_CHUNK) {
        const int jn = min(WF_CHUNK, span - j0);
        unsigned long long m[WF_Q];
#pragma unroll
        for (int q = 0; q < WF_Q; ++q) m[q] = 0ull;
        // bit (jn - 1 - b) of m[q] marks row j0 + b
#pragma unroll 2
        for (int b = 0; b < jn; ++b) {
            const int j = j0 + b;
            float x, y, z;
            st.get(j, x, y, z);
            const bool fin = x <= WF_FIN;
#pragma unroll
            for (int q = 0; q < WF_Q; ++q) {
                const float dx = x - qx[q];
                const float dy = y - qy[q];
                const float dz = z - qz[q];
                const float d2 = dx * dx + dy * dy + dz * dz;
                const bool sel = fin && (unsigned)(j - q) <= (unsigned)w2
                                 && d2 <= thr[q];
                m[q] = (m[q] << 1) | (sel ? 1ull : 0ull);
            }
        }
#pragma unroll
        for (int q = 0; q < WF_Q; ++q) {
            unsigned long long mq = m[q];
            while (mq) {
                const int hb = 63 - __clzll(mq);
                mq ^= 1ull << hb;
                float x, y, z;
                st.get(j0 + jn - 1 - hb, x, y, z);
                const float dx = x - qx[q];
                const float dy = y - qy[q];
                const float dz = z - qz[q];
                const float d2 = dx * dx + dy * dy + dz * dz;
                acc[q][0] = acc[q][0] + 1.f;
                acc[q][1] = acc[q][1] + d2;
                acc[q][2] = acc[q][2] + dx;
                acc[q][3] = acc[q][3] + dy;
                acc[q][4] = acc[q][4] + dz;
                acc[q][5] = acc[q][5] + dx * dx;
                acc[q][6] = acc[q][6] + dy * dy;
                acc[q][7] = acc[q][7] + dz * dz;
                acc[q][8] = acc[q][8] + dx * dy;
                acc[q][9] = acc[q][9] + dx * dz;
                acc[q][10] = acc[q][10] + dy * dz;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < WF_Q; ++q) {
        const long long i = i0 + q;
        if (i >= n) break;
        cnt[i] = acc[q][0];
        tight[i] = acc[q][1];
#pragma unroll
        for (int r = 0; r < 3; ++r) s[3 * i + r] = acc[q][2 + r];
#pragma unroll
        for (int r = 0; r < 6; ++r) m6[6 * i + r] = acc[q][5 + r];
    }
}

template <int K>
static int launch(const float* q, const float* c, int n, int w, float* o0,
                  float* o1, float* o2, float* o3, cudaStream_t st) {
    const int len = WF_Q * WF_THREADS + 2 * w;
    const size_t smem = (size_t)3 * 2 * ((len + 1) / 2) * sizeof(float);
    const long long per = (long long)WF_Q * WF_THREADS;
    const int blocks = (int)(((long long)n + per - 1) / per);
    window_fit_moments<K><<<blocks, WF_THREADS, smem, st>>>(
        q, c, n, w, o0, o1, o2, o3);
    return (int)cudaGetLastError();
}

// sp: (n, 3) f32 queries; pp: (n + 2w, 3) f32 candidates, inf where invalid;
// outputs cnt (n,), tight (n,), s (n, 3), m6 (n, 6) f32.  1 <= k <= 32,
// 1 <= w <= 1920: the strip, 12 * (256 + 2w) bytes, then fits the default
// 48 KB of shared memory.
extern "C" int window_fit_launch(const void* sp, const void* pp, int n, int k,
                                 int w, void* cnt, void* tight, void* s,
                                 void* m6, void* stream) {
    if (n <= 0 || k < 1 || k > 32 || w < 1 || w > 1920)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* q = (const float*)sp;
    const float* c = (const float*)pp;
    float *o0 = (float*)cnt, *o1 = (float*)tight, *o2 = (float*)s,
          *o3 = (float*)m6;
    switch (k) {
#define WF_CASE(K) \
    case K: return launch<K>(q, c, n, w, o0, o1, o2, o3, st);
        WF_CASE(1) WF_CASE(2) WF_CASE(3) WF_CASE(4) WF_CASE(5) WF_CASE(6)
        WF_CASE(7) WF_CASE(8) WF_CASE(9) WF_CASE(10) WF_CASE(11) WF_CASE(12)
        WF_CASE(13) WF_CASE(14) WF_CASE(15) WF_CASE(16) WF_CASE(17)
        WF_CASE(18) WF_CASE(19) WF_CASE(20) WF_CASE(21) WF_CASE(22)
        WF_CASE(23) WF_CASE(24) WF_CASE(25) WF_CASE(26) WF_CASE(27)
        WF_CASE(28) WF_CASE(29) WF_CASE(30) WF_CASE(31) WF_CASE(32)
#undef WF_CASE
    }
    return (int)cudaErrorInvalidValue;
}
