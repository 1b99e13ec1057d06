// K9 las_records_decode: a chunk of LAS point records, their wire bytes as
// read from the file, decoded into a batch's columns on the card.
//
// Replaces no TPU kernel: the JAX package decodes LAS on the host.  Added
// so that a rank's rows go file -> pinned staging -> card as raw records
// (parallel/ingest.py), with no float64 decode or narrowing on the host.
//
// Per record: the position, float32_rn(float64(x) * scale + offset) (or the
// float64 itself), the product and the sum each rounded on their own
// (__dmul_rn, __dadd_rn; the host's converting read has no FMA either), so
// the columns equal the host path's bit for bit; each pass-through field
// copied, a component zero-extended where its carrier is wider (u16 in
// int32, u32 in int64).
//
// Bound on the H100: bytes (n x (record_size + the columns' bytes), ~47 B
// a record for the sheet's format 6 -> float32 positions, int32 intensity,
// uint8 class), a dozen operations a record.  Design: a block stages a tile
// of up to 256 records (a multiple of 16, so every tile starts on a 16-byte
// boundary) into shared memory with coalesced 16-byte loads; thread t then
// takes record t's fields out of shared memory (two aligned words and a
// funnel shift a 32-bit value: records are not word-aligned), stages the
// positions in shared memory so the block stores them as one contiguous run,
// and stores the other columns element t, coalesced across the warp.
#include "common.cuh"

#define LD_THREADS 256
#define LD_MAX_ROWS 256
#define LD_SMEM 49152   // dynamic shared memory a block takes without opt-in
#define LD_PAD 16       // past the records: the funnel shift's second word
#define LD_MAX_FIELDS 16

struct LdField {
    unsigned char* out;  // the column (row 0)
    int offset;          // bytes into the record
    int comp;            // bytes of a wire component: 1, 2, 4 or 8
    int count;           // components a row
    int out_bytes;       // bytes of an output component (>= comp)
};

struct LdParams {
    const unsigned char* rec;
    long long n;         // records of the chunk
    long long row0;      // the output row of the chunk's first record
    int rs;              // record size
    int rows;            // records a block stages
    int pos_offset;
    int pos_kind;        // 0 none, 1 float32, 2 float64
    void* pos;
    double s[3], o[3];
    int n_fields;
    LdField f[LD_MAX_FIELDS];
};

// Four bytes at byte offset a of the staged tile (16-byte aligned).
__device__ __forceinline__ uint32_t ld_u32(const unsigned char* tile, int a) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile);
    return __funnelshift_r(w[a >> 2], w[(a >> 2) + 1], (a & 3) * 8);
}

__device__ __forceinline__ unsigned long long ld_comp(
        const unsigned char* tile, int a, int comp) {
    switch (comp) {
        case 1: return tile[a];
        case 2: return (unsigned long long)tile[a]
                       | ((unsigned long long)tile[a + 1] << 8);
        case 4: return ld_u32(tile, a);
        default: return (unsigned long long)ld_u32(tile, a)
                        | ((unsigned long long)ld_u32(tile, a + 4) << 32);
    }
}

__global__ void __launch_bounds__(LD_THREADS)
las_decode(const LdParams p) {
    extern __shared__ uint4 ld_smem[];
    unsigned char* tile = reinterpret_cast<unsigned char*>(ld_smem);
    const long long first = (long long)blockIdx.x * p.rows;
    const long long left = p.n - first;
    const int rows = left < p.rows ? (int)left : p.rows;
    const int words = (rows * p.rs + 15) >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(p.rec + first * p.rs);
    for (int w = threadIdx.x; w < words; w += LD_THREADS)
        ld_smem[w] = __ldcs(src + w);
    __syncthreads();

    const int t = threadIdx.x;
    if (p.pos_kind) {
        unsigned char* stage = tile + p.rows * p.rs + LD_PAD;
        if (t < rows) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const int x = (int)ld_u32(tile, t * p.rs + p.pos_offset + 4 * a);
                const double w = __dadd_rn(__dmul_rn((double)x, p.s[a]), p.o[a]);
                if (p.pos_kind == 1)
                    reinterpret_cast<float*>(stage)[3 * t + a] =
                        __double2float_rn(w);
                else
                    reinterpret_cast<double*>(stage)[3 * t + a] = w;
            }
        }
        __syncthreads();
        const long long base = 3 * (p.row0 + first);
        if (p.pos_kind == 1) {
            float* out = reinterpret_cast<float*>(p.pos) + base;
            const float* s = reinterpret_cast<const float*>(stage);
            for (int i = t; i < 3 * rows; i += LD_THREADS) out[i] = s[i];
        } else {
            double* out = reinterpret_cast<double*>(p.pos) + base;
            const double* s = reinterpret_cast<const double*>(stage);
            for (int i = t; i < 3 * rows; i += LD_THREADS) out[i] = s[i];
        }
    }
    if (t >= rows) return;
    const long long row = p.row0 + first + t;
    for (int k = 0; k < p.n_fields; ++k) {
        const LdField f = p.f[k];
        for (int c = 0; c < f.count; ++c) {
            const unsigned long long v =
                ld_comp(tile, t * p.rs + f.offset + c * f.comp, f.comp);
            unsigned char* d = f.out + (row * f.count + c) * f.out_bytes;
            switch (f.out_bytes) {
                case 1: *d = (unsigned char)v; break;
                case 2: *reinterpret_cast<uint16_t*>(d) = (uint16_t)v; break;
                case 4: *reinterpret_cast<uint32_t*>(d) = (uint32_t)v; break;
                default: *reinterpret_cast<unsigned long long*>(d) = v;
            }
        }
    }
}

// rec: the chunk's records (16-byte aligned, readable to the next multiple
// of 16 bytes past n * rs); f_out: n_fields column pointers; f_meta: per
// field offset, comp, count, out_bytes (host arrays, read here).
extern "C" int las_decode_launch(const void* rec, long long n, int rs,
                                 long long row0, double sx, double sy,
                                 double sz, double ox, double oy, double oz,
                                 int pos_offset, int pos_kind, void* pos,
                                 int n_fields, const long long* f_out,
                                 const int* f_meta, void* stream) {
    if (n <= 0) return 0;
    const int pos_bytes = pos_kind == 1 ? 12 : pos_kind == 2 ? 24 : 0;
    if (rs <= 0 || n_fields < 0 || n_fields > LD_MAX_FIELDS
        || pos_kind < 0 || pos_kind > 2)
        return (int)cudaErrorInvalidValue;
    int rows = ((LD_SMEM - LD_PAD) / (rs + pos_bytes)) & ~15;
    if (rows > LD_MAX_ROWS) rows = LD_MAX_ROWS;
    if (rows < 16) return (int)cudaErrorInvalidValue;
    LdParams p;
    p.rec = static_cast<const unsigned char*>(rec);
    p.n = n;
    p.row0 = row0;
    p.rs = rs;
    p.rows = rows;
    p.pos_offset = pos_offset;
    p.pos_kind = pos_kind;
    p.pos = pos;
    p.s[0] = sx; p.s[1] = sy; p.s[2] = sz;
    p.o[0] = ox; p.o[1] = oy; p.o[2] = oz;
    p.n_fields = n_fields;
    for (int k = 0; k < n_fields; ++k) {
        p.f[k].out = reinterpret_cast<unsigned char*>(f_out[k]);
        p.f[k].offset = f_meta[4 * k];
        p.f[k].comp = f_meta[4 * k + 1];
        p.f[k].count = f_meta[4 * k + 2];
        p.f[k].out_bytes = f_meta[4 * k + 3];
    }
    const size_t smem = (size_t)rows * rs + LD_PAD + (size_t)rows * pos_bytes;
    const long long blocks = (n + rows - 1) / rows;
    las_decode<<<(unsigned)blocks, LD_THREADS, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
