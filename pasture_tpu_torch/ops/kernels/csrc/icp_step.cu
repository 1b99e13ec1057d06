// K8 icp_step: one exact-correspondence ICP iteration as two launches.
//
// Replaces no TPU kernel: the JAX package leaves this loop to XLA.  On the
// card the eager loop issued ~186 small operations an iteration (tiled
// distance products, argmin, gathers, the normal equations, a library
// Cholesky, se3_exp) and its time was the host's launches; here the pose
// stays in a device buffer and one iteration is
//
//   K8a icp_correspond_accumulate: move each source row by the current
//       (R, t), find its exact nearest valid target row, and sum the
//       Gauss-Newton terms of the inliers into per-8-query partials;
//   K8b icp_solve_update (one block): reduce the partials, solve the damped
//       6x6 system, and compose the pose with se3_exp(-x).
//
// K8a, bound on the H100: instruction issue.  A pair costs ~8 operations
// (3 differences, 3 squares, 2 sums) and a compare; the bytes are the two
// clouds, read once a block from L2.  Design: a warp owns QPW consecutive
// queries, held in registers by every lane; the block's 256 threads copy a
// tile of 2048 target rows into shared memory (x, y, z planes, +inf where
// a row is invalid) and lane l of each warp scans rows l, l + 32, ... of
// the tile for all of the warp's queries, so each shared-memory load serves
// QPW pairs and the lanes read consecutive words (no bank conflicts).  The
// target range is split across the 32 lanes of a warp and not across
// blocks, so a query's merge is five warp shuffles and needs no second
// pass: at the odometry cell's 2.4 k x 2.4 k one query a warp gives 300
// blocks of 8 queries for 132 SMs (14 us); at 1 M x 1 M eight queries a
// warp give 16 384 blocks and an eighth of the L2 traffic (483 ms against
// 656 ms at one; the wrapper picks QPW from the query count).  The match
// is the lexicographic minimum of (d2, index) -- a lane scans its rows in
// ascending order with a strict <, the merge takes the smaller index on
// equal d2 -- which is the plain version's argmin, first index on a tie,
// whatever the split.
//
// d2 is the direct ((dx*dx + dy*dy) + dz*dz) of dx = target - moved in
// float32 (no TF32, no |q|^2 + |p|^2 - 2 q.p cancellation).  A query's
// residual and Jacobian are float32 as in the eager loop; their products
// are taken in double (exact: 24 + 24 bits) and every sum is double.  The
// sums have a fixed order, so the result is the same run to run, with no
// atomics: a query's 29 terms (H's 21 upper entries row by row, b's 6, the
// count, d2) are summed 8 queries at a time in ascending order from +0.0;
// K8b's lane l sums partials l, l + 32, ... in ascending order and the 32
// lane sums meet in a butterfly (xor 16, 8, 4, 2, 1).  A partial of
// queries past n, invalid or beyond the distance is +0.0, and adding +0.0
// leaves a sum that is never -0.0 unchanged, so the padding does not
// change a bit.
//
// K8b: the damped Cholesky and both triangular solves in double, then
// se3_exp of -x: its coefficients sin(t)/t, (1 - cos t)/t^2 and
// (t - sin t)/t^3 as their Taylor series in t^2 (13 terms, Horner) for
// t < 2 -- which below 1e-8 is se3.py's small-angle branch to every float
// digit, and avoids the cancellation of 1 - cos t above it -- and from
// sin and cos beyond (a step of more than 2 rad).  A pivot that is not
// positive leaves the pose unchanged.  The pose is written back in
// float32, with the rmse, sqrt(sum d2 / max(count, 1)) of the inliers
// before the update, and the inlier count.
//
// Built with -fmad=false like every source here, so each operation rounds
// once and the kernels equal icp_step_kernel.py's plain version bit for
// bit (but for the sin/cos branch, libm against CUDA's).
#include <math.h>

#include "common.cuh"

#define IS_THREADS 256
#define IS_WARPS (IS_THREADS / 32)
#define IS_TILE 2048          // target rows a block holds at a time
#define IS_SUMQ 8             // queries a partial sums
#define IS_TERMS 29           // H's 21 upper entries, b's 6, count, sum d2
#define IS_NONE 0x7fffffff    // no match
#define IS_SERIES 13          // Taylor terms of se3_exp's coefficients
#define IS_FULL 0xffffffffu

// (-1)^k / (2k + 1)!, (-1)^k / (2k + 2)!, (-1)^k / (2k + 3)!
__constant__ double IS_A[IS_SERIES] = {
    0x1.0000000000000p+0, -0x1.5555555555555p-3, 0x1.1111111111111p-7,
    -0x1.a01a01a01a01ap-13, 0x1.71de3a556c734p-19, -0x1.ae64567f544e4p-26,
    0x1.6124613a86d09p-33, -0x1.ae7f3e733b81fp-41, 0x1.952c77030ad4ap-49,
    -0x1.2f49b46814157p-57, 0x1.71b8ef6dcf572p-66, -0x1.761b41316381ap-75,
    0x1.3f3ccdd165fa9p-84};
__constant__ double IS_B[IS_SERIES] = {
    0x1.0000000000000p-1, -0x1.5555555555555p-5, 0x1.6c16c16c16c17p-10,
    -0x1.a01a01a01a01ap-16, 0x1.27e4fb7789f5cp-22, -0x1.1eed8eff8d898p-29,
    0x1.93974a8c07c9dp-37, -0x1.ae7f3e733b81fp-45, 0x1.6827863b97d97p-53,
    -0x1.e542ba4020225p-62, 0x1.0ce396db7f853p-70, -0x1.f2cf01972f578p-80,
    0x1.88e85fc6a4e5ap-89};
__constant__ double IS_C[IS_SERIES] = {
    0x1.5555555555555p-3, -0x1.1111111111111p-7, 0x1.a01a01a01a01ap-13,
    -0x1.71de3a556c734p-19, 0x1.ae64567f544e4p-26, -0x1.6124613a86d09p-33,
    0x1.ae7f3e733b81fp-41, -0x1.952c77030ad4ap-49, 0x1.2f49b46814157p-57,
    -0x1.71b8ef6dcf572p-66, 0x1.761b41316381ap-75, -0x1.3f3ccdd165fa9p-84,
    0x1.d1ab1c2dccea3p-94};

// The 29 terms of one inlier: moved m, its match q, the match's normal n.
__device__ __forceinline__ void is_terms(float mx, float my, float mz,
                                         float qx, float qy, float qz,
                                         const float* nrm, int j,
                                         int point_to_plane, float d2,
                                         double* out) {
    const float ex = mx - qx, ey = my - qy, ez = mz - qz;
    int o = 0;
    if (point_to_plane) {
        const float nx = nrm[3 * (long long)j], ny = nrm[3 * (long long)j + 1],
                    nz = nrm[3 * (long long)j + 2];
        const float r = ex * nx + ey * ny + ez * nz;
        // J = [n, m x n] for the twist [rho, phi]
        const double jac[6] = {nx, ny, nz, my * nz - mz * ny,
                               mz * nx - mx * nz, mx * ny - my * nx};
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
            for (int b = a; b < 6; ++b) out[o++] = jac[a] * jac[b];
#pragma unroll
        for (int a = 0; a < 6; ++a) out[o++] = jac[a] * (double)r;
    } else {
        // J = [I, -[m]x], one row per residual component
        const double jac[3][6] = {{1.0, 0.0, 0.0, 0.0, mz, -my},
                                  {0.0, 1.0, 0.0, -mz, 0.0, mx},
                                  {0.0, 0.0, 1.0, my, -mx, 0.0}};
        const double e[3] = {ex, ey, ez};
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
            for (int b = a; b < 6; ++b)
                out[o++] = jac[0][a] * jac[0][b] + jac[1][a] * jac[1][b] +
                           jac[2][a] * jac[2][b];
#pragma unroll
        for (int a = 0; a < 6; ++a)
            out[o++] = jac[0][a] * e[0] + jac[1][a] * e[1] + jac[2][a] * e[2];
    }
    out[27] = 1.0;
    out[28] = (double)d2;
}

template <int QPW>
__global__ void __launch_bounds__(IS_THREADS)
icp_correspond_accumulate(const float* __restrict__ src,
                          const unsigned char* __restrict__ src_valid, int n,
                          const float* __restrict__ tgt,
                          const unsigned char* __restrict__ tgt_valid,
                          const float* __restrict__ nrm, int m,
                          const float* __restrict__ pose, float max_d2,
                          int point_to_plane, double* __restrict__ partial,
                          int parts) {
    __shared__ float sx[IS_TILE], sy[IS_TILE], sz[IS_TILE];
    __shared__ double terms[IS_WARPS * QPW][IS_TERMS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long q0 =
        ((long long)blockIdx.x * IS_WARPS + warp) * QPW;
    float rot[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = pose[k];
    const float tx = pose[9], ty = pose[10], tz = pose[11];
    float mx[QPW], my[QPW], mz[QPW], bd[QPW];
    int bj[QPW];
#pragma unroll
    for (int q = 0; q < QPW; ++q) {
        const long long i = q0 + q;
        float px = 0.f, py = 0.f, pz = 0.f;
        if (i < n) {
            px = src[3 * i];
            py = src[3 * i + 1];
            pz = src[3 * i + 2];
        }
        mx[q] = pt_affine_row(rot, tx, px, py, pz);
        my[q] = pt_affine_row(rot + 3, ty, px, py, pz);
        mz[q] = pt_affine_row(rot + 6, tz, px, py, pz);
        bd[q] = INFINITY;
        bj[q] = IS_NONE;
    }
    for (int base = 0; base < m; base += IS_TILE) {
        const int rows = min(IS_TILE, m - base);
        __syncthreads();                  // the last tile's readers are done
        for (int f = threadIdx.x; f < rows; f += IS_THREADS) {
            const long long j = base + f;
            float x = tgt[3 * j], y = tgt[3 * j + 1], z = tgt[3 * j + 2];
            if (!tgt_valid[j]) x = y = z = INFINITY;
            sx[f] = x;
            sy[f] = y;
            sz[f] = z;
        }
        __syncthreads();
        for (int f = lane; f < rows; f += 32) {
            const float x = sx[f], y = sy[f], z = sz[f];
#pragma unroll
            for (int q = 0; q < QPW; ++q) {
                const float dx = x - mx[q], dy = y - my[q], dz = z - mz[q];
                const float d = dx * dx + dy * dy + dz * dz;
                if (d < bd[q]) {
                    bd[q] = d;
                    bj[q] = base + f;
                }
            }
        }
    }
    // the warp's minimum of (d2, index) for each query, on every lane
#pragma unroll
    for (int q = 0; q < QPW; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float od = __shfl_xor_sync(IS_FULL, bd[q], o);
            const int oj = __shfl_xor_sync(IS_FULL, bj[q], o);
            if (od < bd[q] || (od == bd[q] && oj < bj[q])) {
                bd[q] = od;
                bj[q] = oj;
            }
        }
    }
#pragma unroll
    for (int q = 0; q < QPW; ++q) {
        if (lane != q) continue;
        double* out = terms[warp * QPW + q];
        const long long i = q0 + q;
        if (i < n && src_valid[i] && bd[q] < max_d2) {
            const long long j = bj[q];
            is_terms(mx[q], my[q], mz[q], tgt[3 * j], tgt[3 * j + 1],
                     tgt[3 * j + 2], nrm, bj[q], point_to_plane, bd[q], out);
        } else {
            for (int c = 0; c < IS_TERMS; ++c) out[c] = 0.0;
        }
    }
    __syncthreads();
    constexpr int groups = IS_WARPS * QPW / IS_SUMQ;
    if (threadIdx.x < groups * IS_TERMS) {
        const int g = threadIdx.x / IS_TERMS, c = threadIdx.x % IS_TERMS;
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < IS_SUMQ; ++k)
            acc = acc + terms[g * IS_SUMQ + k][c];
        partial[(long long)c * parts + (long long)blockIdx.x * groups + g] =
            acc;
    }
}

__device__ double is_series(const double* coef, double x) {
    double acc = coef[IS_SERIES - 1];
    for (int k = IS_SERIES - 2; k >= 0; --k) acc = acc * x + coef[k];
    return acc;
}

__global__ void __launch_bounds__(IS_THREADS)
icp_solve_update(const double* __restrict__ partial, int parts,
                 float* __restrict__ pose, double damping,
                 float* __restrict__ rmse, int* __restrict__ nin) {
    __shared__ double sums[IS_TERMS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = warp; c < IS_TERMS; c += IS_WARPS) {
        const double* col = partial + (long long)c * parts;
        double s = 0.0;
        for (int p = lane; p < parts; p += 32) s = s + col[p];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            s = s + __shfl_xor_sync(IS_FULL, s, o);
        if (lane == 0) sums[c] = s;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    double h[6][6], b[6];
    int o = 0;
    for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c) {
            h[a][c] = sums[o];
            h[c][a] = sums[o++];
        }
    for (int a = 0; a < 6; ++a) {
        b[a] = sums[o++];
        h[a][a] = h[a][a] + damping;
    }
    // Cholesky H = L L^T, then L y = b, L^T x = y
    double l[6][6], x[6];
    bool ok = true;
    for (int j = 0; j < 6 && ok; ++j) {
        double s = h[j][j];
        for (int k = 0; k < j; ++k) s = s - l[j][k] * l[j][k];
        if (!(s > 0.0)) {
            ok = false;
            break;
        }
        l[j][j] = sqrt(s);
        for (int i = j + 1; i < 6; ++i) {
            double v = h[i][j];
            for (int k = 0; k < j; ++k) v = v - l[i][k] * l[j][k];
            l[i][j] = v / l[j][j];
        }
    }
    if (ok) {
        for (int i = 0; i < 6; ++i) {
            double v = b[i];
            for (int k = 0; k < i; ++k) v = v - l[i][k] * x[k];
            x[i] = v / l[i][i];
        }
        for (int i = 5; i >= 0; --i) {
            double v = x[i];
            for (int k = i + 1; k < 6; ++k) v = v - l[k][i] * x[k];
            x[i] = v / l[i][i];
        }
        // se3_exp(-x): R = I + A K + B K^2, V = I + B K + C K^2, dt = V rho
        const double rho[3] = {-x[0], -x[1], -x[2]};
        const double p0 = -x[3], p1 = -x[4], p2 = -x[5];
        const double th2 = p0 * p0 + p1 * p1 + p2 * p2;
        double ca, cb, cc;
        if (th2 < 4.0) {
            ca = is_series(IS_A, th2);
            cb = is_series(IS_B, th2);
            cc = is_series(IS_C, th2);
        } else {
            const double th = sqrt(th2), sn = sin(th), cs = cos(th);
            ca = sn / th;
            cb = (1.0 - cs) / th2;
            cc = (th - sn) / (th2 * th);
        }
        const double k[3][3] = {{0.0, -p2, p1}, {p2, 0.0, -p0},
                                {-p1, p0, 0.0}};
        const double ph[3] = {p0, p1, p2};
        double dr[3][3], v[3][3];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                const double k2 = ph[i] * ph[j] - (i == j ? th2 : 0.0);
                const double id = i == j ? 1.0 : 0.0;
                dr[i][j] = id + ca * k[i][j] + cb * k2;
                v[i][j] = id + cb * k[i][j] + cc * k2;
            }
        double r0[3][3], t0[3];
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) r0[i][j] = pose[3 * i + j];
            t0[i] = pose[9 + i];
        }
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j)
                pose[3 * i + j] = (float)(dr[i][0] * r0[0][j] +
                                          dr[i][1] * r0[1][j] +
                                          dr[i][2] * r0[2][j]);
            const double dt =
                v[i][0] * rho[0] + v[i][1] * rho[1] + v[i][2] * rho[2];
            pose[9 + i] = (float)(dr[i][0] * t0[0] + dr[i][1] * t0[1] +
                                  dr[i][2] * t0[2] + dt);
        }
    }
    const double cnt = sums[27];
    *rmse = (float)sqrt(sums[28] / (cnt > 1.0 ? cnt : 1.0));
    *nin = (int)cnt;
}

template <int QPW>
static int launch_a(const float* src, const unsigned char* sv, int n,
                    const float* tgt, const unsigned char* tv,
                    const float* nrm, int m, const float* pose, float max_d2,
                    int ptp, double* partial, int parts, cudaStream_t st) {
    const int per = IS_WARPS * QPW;
    const int blocks = (n + per - 1) / per;
    icp_correspond_accumulate<QPW><<<blocks, IS_THREADS, 0, st>>>(
        src, sv, n, tgt, tv, nrm, m, pose, max_d2, ptp, partial, parts);
    return (int)cudaGetLastError();
}

static int correspond(const void* src, const void* sv, int n, const void* tgt,
                      const void* tv, const void* nrm, int m, const void* pose,
                      float max_d2, int ptp, void* partial, int parts, int qpw,
                      cudaStream_t st) {
    const float *s = (const float*)src, *t = (const float*)tgt,
                *nr = (const float*)nrm, *ps = (const float*)pose;
    const unsigned char *a = (const unsigned char*)sv,
                        *b = (const unsigned char*)tv;
    double* pt = (double*)partial;
    switch (qpw) {
        case 1: return launch_a<1>(s, a, n, t, b, nr, m, ps, max_d2, ptp, pt,
                                   parts, st);
        case 8: return launch_a<8>(s, a, n, t, b, nr, m, ps, max_d2, ptp, pt,
                                   parts, st);
    }
    return (int)cudaErrorInvalidValue;
}

static int solve(const void* partial, int parts, void* pose, double damping,
                 void* rmse, void* nin, cudaStream_t st) {
    icp_solve_update<<<1, IS_THREADS, 0, st>>>(
        (const double*)partial, parts, (float*)pose, damping, (float*)rmse,
        (int*)nin);
    return (int)cudaGetLastError();
}

static bool bad_sizes(int n, int m, int parts, int qpw) {
    if (n < 1 || m < 1 || !(qpw == 1 || qpw == 8))
        return true;
    const long long per = (long long)IS_WARPS * qpw;
    return parts != ((n + per - 1) / per) * (per / IS_SUMQ);
}

// src (n, 3), tgt and nrm (m, 3) f32 (nrm unread for point-to-point);
// src_valid (n,), tgt_valid (m,) bytes 0/1; pose (12,) f32, R row-major
// then t, read; partial (29, parts) f64 with parts = ceil(n / (8 qpw)) *
// qpw, written.  K8a once.
extern "C" int icp_correspond_launch(const void* src, const void* src_valid,
                                     int n, const void* tgt,
                                     const void* tgt_valid, const void* nrm,
                                     int m, const void* pose, float max_d2,
                                     int point_to_plane, void* partial,
                                     int parts, int qpw, void* stream) {
    if (bad_sizes(n, m, parts, qpw)) return (int)cudaErrorInvalidValue;
    return correspond(src, src_valid, n, tgt, tgt_valid, nrm, m, pose, max_d2,
                      point_to_plane, partial, parts, qpw,
                      (cudaStream_t)stream);
}

// K8b once: partial (29, parts) f64 read; pose (12,) f32 updated in place;
// rmse (f32) and nin (i32) written.
extern "C" int icp_solve_launch(const void* partial, int parts, void* pose,
                                double damping, void* rmse, void* nin,
                                void* stream) {
    if (parts < 1) return (int)cudaErrorInvalidValue;
    return solve(partial, parts, pose, damping, rmse, nin,
                 (cudaStream_t)stream);
}

// `iterations` x (K8a, K8b) on one stream, nothing read back between them.
extern "C" int icp_iterate_launch(const void* src, const void* src_valid,
                                  int n, const void* tgt,
                                  const void* tgt_valid, const void* nrm,
                                  int m, void* pose, float max_d2,
                                  int point_to_plane, double damping,
                                  void* partial, int parts, int qpw,
                                  int iterations, void* rmse, void* nin,
                                  void* stream) {
    if (bad_sizes(n, m, parts, qpw) || iterations < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    for (int it = 0; it < iterations; ++it) {
        int code = correspond(src, src_valid, n, tgt, tgt_valid, nrm, m, pose,
                              max_d2, point_to_plane, partial, parts, qpw, st);
        if (code != 0) return code;
        code = solve(partial, parts, pose, damping, rmse, nin, st);
        if (code != 0) return code;
    }
    return 0;
}
