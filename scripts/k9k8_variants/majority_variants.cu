// K9's variants for scripts/k9k8_variants.py: a copy of the shipped
// ba_tpu_torch/ops/csrc/majority.cu (ba_majority) with its tile shape and
// its staging open to -D flags (MAJ_TILE_THREADS, MAJ_ROWS_A_THREAD,
// MAJ_CP_ASYNC = 0: plain 16-byte loads through registers instead of
// cp.async; MAJ_OLD_FLAGS = 1: a zero-byte test for each code), its warp
// path's (MAJ_WARP_PAIR = 1: two chunks a pass;
// MAJ_WARP_ROWS = 4: four rows a warp, the mask chunks kept in registers
// while the mask row repeats; MAJ_DOUBLE_BUFFER = 1: a resident grid
// staging its next tile while it tallies this one), and the first port's design (v1_ba_majority: one thread a row of
// K < 33 with byte loads, or four-byte words where K % 4 = 0 and the bases
// are aligned; a warp a longer row, four-byte words a lane; a 64-bit
// division a row).  Each is bit-equal to the shipped kernel.

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define MAJ_FN __host__ __device__ __forceinline__
#else
#define MAJ_FN static inline
struct uint4 {
    uint32_t x, y, z, w;
};
#endif

#ifndef MAJ_TILE_THREADS
#define MAJ_TILE_THREADS 128
#endif
#ifndef MAJ_ROWS_A_THREAD
#define MAJ_ROWS_A_THREAD 4
#endif
#ifndef MAJ_CP_ASYNC
#define MAJ_CP_ASYNC 1
#endif
constexpr int TILE_THREADS = MAJ_TILE_THREADS;
constexpr int ROWS_A_THREAD = MAJ_ROWS_A_THREAD;
constexpr int TILE_ROWS = TILE_THREADS * ROWS_A_THREAD;
constexpr int WARP_THREADS = 256;  // 8 rows a block
constexpr int TILE_MAX_K = 32;

MAJ_FN int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// (hi:lo) >> s, the low word (s in [0, 32)).
MAJ_FN uint32_t funnel_r(uint32_t lo, uint32_t hi, int s) {
#if defined(__CUDA_ARCH__)
    return __funnelshift_r(lo, hi, (unsigned)s);
#else
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
#endif
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no carry
// crosses a byte, Hacker's Delight 6-1).
MAJ_FN uint32_t zero_bytes(uint32_t x) {
    const uint32_t y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
    return ~(y | x | 0x7F7F7F7Fu);
}

// A row's flags: word j's ATTACK and RETREAT flags (0x80 a byte) shifted
// right by j (j < 8 keeps them apart), and any valid byte.
struct Flags {
    uint32_t att, ret, any;
};

#ifndef MAJ_OLD_FLAGS
#define MAJ_OLD_FLAGS 0  // 1: a zero-byte test a code and a word (the first tile design)
#endif
#if MAJ_OLD_FLAGS
MAJ_FN void flag_word(uint32_t a, uint32_t v, int j, Flags& fl) {
    const uint32_t valid = ~zero_bytes(v) & 0x80808080u;
    fl.att |= (zero_bytes(a ^ 0x01010101u) & valid) >> j;
    fl.ret |= (zero_bytes(a) & valid) >> j;
    fl.any |= valid;
}
#else
MAJ_FN void flag_word(uint32_t a, uint32_t v, int j, Flags& fl) {
    // 0x80 where v's byte is non-zero: (v & 0x7F) + 0x7F carries into bit 7 unless it is 0
    const uint32_t valid = (((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & 0x80808080u;
    // 0x80 where a's byte is 0 or 1 (bits 1..7 clear) and valid
    const uint32_t e = ~(((a & 0x7E7E7E7Eu) + 0x7F7F7F7Fu) | a) & valid;
    const uint32_t one = a << 7;  // each byte's bit 0 at its bit 7: ATTACK, not RETREAT
    fl.att |= (e & one) >> j;
    fl.ret |= (e & ~one) >> j;
    fl.any |= valid;
}
#endif

MAJ_FN int8_t majority_of(int att, int ret, bool any, int8_t fallback) {
    if (!any) return fallback;
    return att > ret ? 1 : (ret > att ? 0 : 2);
}

// n / d for n < 2^31 by a multiply and a shift (d >= 1; CUTLASS's
// FastDivmod): mul = ceil(2^(31 + l) / d), l = ceil(log2 d).
struct FastDiv {
    uint32_t d, mul, shift;
};

MAJ_FN FastDiv fast_div(uint32_t d) {
    int l = 0;
    while ((1ull << l) < d) l++;
    FastDiv f = {d, 0u, 0u};
    if (d > 1) {
        f.mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
        f.shift = (uint32_t)(l - 1);
    }
    return f;
}

MAJ_FN uint32_t div_by(uint32_t n, const FastDiv& f) {
    if (f.d == 1) return n;
#if defined(__CUDA_ARCH__)
    return __umulhi(n, f.mul) >> f.shift;
#else
    return (uint32_t)(((uint64_t)n * f.mul) >> 32) >> f.shift;
#endif
}

enum TileMode { TILE_LINEAR = 0, TILE_IN_RUN = 1 };

struct MajArgs {
    long long R, S, P;
    int K, mode;
    long long tiles_a_run;  // TILE_IN_RUN: tiles in one (g, s) run of P rows
    FastDiv fd_p, fd_s;
    uint32_t tail;  // the last word's byte mask (K % 4 bytes, or all four)
    const uint8_t* a;
    const uint8_t* v;
    const int8_t* f;
    int8_t* out;
};

// Shared-memory layout of a tile: each run staged from its 16-byte aligned
// chunk, so byte x of the run sits at (x & 15) + its offset; 32 bytes of
// slack cover the shift and the extra word a realigned read takes.
MAJ_FN int round16(int n) { return (n + 15) & ~15; }
MAJ_FN int tile_run_bytes(int K) { return round16(TILE_ROWS * K + 32); }
MAJ_FN int tile_smem_bytes(int K) {
    return 2 * tile_run_bytes(K) + 2 * round16(TILE_ROWS + 32);
}

struct TileGeom {
    long long r0, m0;   // first row, first staged mask row
    int rows, mask_rows;
    int p0, s0;         // r0's position in its (g, s) run and its g
    int mskip;          // m0 - g0 P: the staged mask rows start mskip into g0's
};

MAJ_FN TileGeom tile_geom(const MajArgs& x, long long tile) {
    TileGeom t;
    long long q0;
    if (x.mode == TILE_IN_RUN) {
        q0 = (uint32_t)tile / (uint32_t)x.tiles_a_run;
        const long long j = tile - q0 * x.tiles_a_run;
        t.r0 = q0 * x.P + j * TILE_ROWS;
        const long long left = x.P - j * TILE_ROWS;
        t.rows = (int)(left < TILE_ROWS ? left : TILE_ROWS);
    } else {
        t.r0 = tile * TILE_ROWS;
        q0 = div_by((uint32_t)t.r0, x.fd_p);
        const long long left = x.R - t.r0;
        t.rows = (int)(left < TILE_ROWS ? left : TILE_ROWS);
    }
    t.p0 = (int)(t.r0 - q0 * x.P);
    const long long g0 = div_by((uint32_t)q0, x.fd_s);
    t.s0 = (int)(q0 - g0 * x.S);
    if (x.mode == TILE_IN_RUN || x.S == 1) {  // the mask rows run with the rows
        t.m0 = g0 * x.P + t.p0;
        t.mask_rows = t.rows;
    } else {  // every mask row of the g the tile touches (at most TILE_ROWS)
        const long long g1 = div_by(div_by((uint32_t)(t.r0 + t.rows - 1), x.fd_p), x.fd_s);
        t.m0 = g0 * x.P;
        t.mask_rows = (int)((g1 - g0 + 1) * x.P);
    }
    t.mskip = (int)(t.m0 - g0 * x.P);
    return t;
}

// Copy one 16-byte aligned chunk into shared memory.
MAJ_FN void copy16(uint8_t* dst, const uint8_t* src) {
#if defined(__CUDA_ARCH__) && MAJ_CP_ASYNC
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#elif defined(__CUDA_ARCH__)
    *(uint4*)dst = __ldg((const uint4*)src);
#else
    memcpy(dst, src, 16);
#endif
}

// The aligned chunks overlapping [g, g + n), thread tid of nthr.
MAJ_FN void stage_run(uint8_t* sm, const uint8_t* g, long long n, int tid, int nthr) {
    const uint8_t* base = (const uint8_t*)((uintptr_t)g & ~(uintptr_t)15);
    const int chunks = (int)((g + n - base + 15) >> 4);
    for (int c = tid; c < chunks; c += nthr) copy16(sm + 16 * c, base + 16 * c);
}

MAJ_FN void tile_stage(const MajArgs& x, const TileGeom& t, uint8_t* sm, int tid, int nthr) {
    const int run = tile_run_bytes(x.K);
    stage_run(sm, x.a + t.r0 * x.K, (long long)t.rows * x.K, tid, nthr);
    stage_run(sm + run, x.v + t.m0 * x.K, (long long)t.mask_rows * x.K, tid, nthr);
    stage_run(sm + 2 * run, (const uint8_t*)x.f + t.r0, t.rows, tid, nthr);
}

// NW words a row from shared memory at byte offset o, realigned.
template <int NW>
MAJ_FN void load_row(const uint8_t* sm, int o, uint32_t w[NW]) {
    const uint32_t* p = (const uint32_t*)(sm + (o & ~3));
    const int s = 8 * (o & 3);
    uint32_t raw[NW + 1];
#pragma unroll
    for (int j = 0; j <= NW; j++) raw[j] = p[j];
#pragma unroll
    for (int j = 0; j < NW; j++) w[j] = funnel_r(raw[j], raw[j + 1], s);
}

// Thread tid's ROWS_A_THREAD consecutive rows of the staged tile.
template <int NW>
MAJ_FN void tile_rows(const MajArgs& x, const TileGeom& t, uint8_t* sm, int tid) {
    const int run = tile_run_bytes(x.K);
    const uint8_t* sa = sm;
    const uint8_t* sv = sm + run;
    const uint8_t* sf = sm + 2 * run;
    uint8_t* so = sm + 2 * run + round16(TILE_ROWS + 32);
    const int a_sh = (int)((uintptr_t)(x.a + t.r0 * x.K) & 15);
    const int v_sh = (int)((uintptr_t)(x.v + t.m0 * x.K) & 15);
    const int f_sh = (int)((uintptr_t)(x.f + t.r0) & 15);
    const int o_sh = (int)((uintptr_t)(x.out + t.r0) & 15);
    const int i0 = tid * ROWS_A_THREAD;
    if (i0 >= t.rows) return;
    // position of row i0: p in its run, s in its g, mask row relative to m0
    const uint32_t pp = (uint32_t)(t.p0 + i0);
    const uint32_t dq = div_by(pp, x.fd_p);
    int p = (int)(pp - dq * (uint32_t)x.P);
    const uint32_t ss = (uint32_t)t.s0 + dq;
    const uint32_t dg = div_by(ss, x.fd_s);
    int s = (int)(ss - dg * (uint32_t)x.S);
    int mrel = (int)(dg * (uint32_t)x.P) + p - t.mskip;
    const int P = (int)x.P, S = (int)x.S;
#pragma unroll
    for (int k = 0; k < ROWS_A_THREAD; k++) {
        const int i = i0 + k;
        if (i < t.rows) {
            uint32_t a[NW], v[NW];
            load_row<NW>(sa, a_sh + i * x.K, a);
            load_row<NW>(sv, v_sh + mrel * x.K, v);
            v[NW - 1] &= x.tail;
            Flags fl = {0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < NW; j++) flag_word(a[j], v[j], j, fl);
            so[o_sh + i] = (uint8_t)majority_of(popc32(fl.att), popc32(fl.ret), fl.any != 0u,
                                                (int8_t)sf[f_sh + i]);
        }
        p++;
        mrel++;
        if (p == P) {  // the next run: mask rows back to p = 0, or on to the next g
            p = 0;
            mrel -= P;
            if (++s == S) {
                s = 0;
                mrel += P;
            }
        }
    }
}

// out[r0, r0 + rows) from shared memory: whole aligned chunks by 16-byte
// stores, the partial ones at either end byte by byte.
MAJ_FN void tile_store(const MajArgs& x, const TileGeom& t, const uint8_t* sm, int tid,
                       int nthr) {
    const int run = tile_run_bytes(x.K);
    const uint8_t* so = sm + 2 * run + round16(TILE_ROWS + 32);
    uint8_t* g = (uint8_t*)(x.out + t.r0);
    uint8_t* base = (uint8_t*)((uintptr_t)g & ~(uintptr_t)15);
    const int lo = (int)(g - base), hi = lo + t.rows;
    const int chunks = (hi + 15) >> 4;
    for (int c = tid; c < chunks; c += nthr) {
        if (16 * c >= lo && 16 * c + 16 <= hi) {
            *(uint4*)(base + 16 * c) = *(const uint4*)(so + 16 * c);
        } else {
            for (int b = 16 * c; b < 16 * c + 16; b++)
                if (b >= lo && b < hi) base[b] = so[b];
        }
    }
}

// ---- rows of K >= 33: a warp a row --------------------------------------

// The byte mask of a word's bytes [lo, hi) (clamped to [0, 4]).
MAJ_FN uint32_t byte_range(int lo, int hi) {
    lo = lo < 0 ? 0 : (lo > 4 ? 4 : lo);
    hi = hi < 0 ? 0 : (hi > 4 ? 4 : hi);
    const uint32_t below_hi = (uint32_t)((1ull << (8 * hi)) - 1);
    const uint32_t below_lo = (uint32_t)((1ull << (8 * lo)) - 1);
    return below_hi & ~below_lo;
}

MAJ_FN void load16(const uint8_t* p, uint32_t w[4]) {
    const uint4 q = *(const uint4*)p;
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
}

#ifndef MAJ_WARP_PAIR
#define MAJ_WARP_PAIR 0  // 1: two chunks a pass, both loads issued first
#endif
#ifndef MAJ_WARP_ROWS
#define MAJ_WARP_ROWS 1  // rows a warp, the mask chunks kept while the mask row repeats
#endif

// Where row r's answers and mask row lie, and its answer chunks.
struct RowPos {
    const uint8_t* arow;
    const uint8_t* vrow;
    const uint8_t* a0;  // the row's first aligned chunk
    long long delta, m;  // mask byte of answer byte y: y + delta; the mask row
    int vsh, chunks;
};

MAJ_FN RowPos row_pos(const MajArgs& x, long long r) {
    RowPos w;
    const uint32_t q = div_by((uint32_t)r, x.fd_p);
    const long long p = r - (long long)q * x.P;
    w.m = (long long)div_by(q, x.fd_s) * x.P + p;
    w.arow = x.a + r * x.K;
    w.vrow = x.v + w.m * x.K;
    w.a0 = (const uint8_t*)((uintptr_t)w.arow & ~(uintptr_t)15);
    w.delta = w.vrow - w.arow;
    w.vsh = (int)((uintptr_t)(w.a0 + w.delta) & 15);  // the same for every chunk
    w.chunks = (int)((w.arow + x.K - w.a0 + 15) >> 4);
    return w;
}

// The mask's 16 bytes matching answer chunk c (zero where the two aligned
// chunks it spans hold none of the row's mask bytes).
MAJ_FN void mask_chunk(const MajArgs& x, const RowPos& w, int c, uint32_t v[4]) {
    const uint8_t* cv = w.a0 + 16 * c + w.delta;
    if (w.vsh == 0) {
        load16(cv, v);
        return;
    }
    const uint8_t* v0 = cv - w.vsh;
    const uint8_t* need_lo = cv > w.vrow ? cv : w.vrow;
    const uint8_t* need_hi = cv + 16 < w.vrow + x.K ? cv + 16 : w.vrow + x.K;
    uint32_t u[9] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (need_lo < v0 + 16) load16(v0, u);
    if (need_hi > v0 + 16) load16(v0 + 16, u + 4);
    const int ws = w.vsh >> 2, bs = 8 * (w.vsh & 3);
    uint32_t y[5];
#pragma unroll
    for (int k = 0; k < 5; k++)
        y[k] = ws == 0 ? u[k] : (ws == 1 ? u[k + 1] : (ws == 2 ? u[k + 2] : u[k + 3]));
#pragma unroll
    for (int k = 0; k < 4; k++) v[k] = funnel_r(y[k], y[k + 1], bs);
}

// Chunk c's counts; bytes outside the row count for nothing.
MAJ_FN void tally_chunk(const MajArgs& x, const RowPos& w, int c, const uint32_t a[4],
                        const uint32_t vin[4], int& att, int& ret, uint32_t& any) {
    uint32_t v[4] = {vin[0], vin[1], vin[2], vin[3]};
    const int lo = (int)(w.arow - (w.a0 + 16 * c)), hi = lo + x.K;
    if (lo > 0 || hi < 16) {
#pragma unroll
        for (int k = 0; k < 4; k++) v[k] &= byte_range(lo - 4 * k, hi - 4 * k);
    }
    Flags fl = {0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; k++) flag_word(a[k], v[k], k, fl);
    att += popc32(fl.att);
    ret += popc32(fl.ret);
    any |= fl.any;
}

// Lane `lane` of `lanes` on row r: chunks lane, lane + lanes, ..., two a
// pass (both chunks' loads issued before either is tallied).
MAJ_FN void warp_lane(const MajArgs& x, long long r, int lane, int lanes, int& att, int& ret,
                      bool& any) {
    const RowPos w = row_pos(x, r);
    att = ret = 0;
    uint32_t anyw = 0u;
    const int step = MAJ_WARP_PAIR ? 2 * lanes : lanes;
    for (int c = lane; c < w.chunks; c += step) {
        uint32_t a0[4], v0[4], a1[4], v1[4];
        const int c2 = c + lanes;
        const bool two = MAJ_WARP_PAIR && c2 < w.chunks;
        load16(w.a0 + 16 * c, a0);
        mask_chunk(x, w, c, v0);
        if (two) {
            load16(w.a0 + 16 * c2, a1);
            mask_chunk(x, w, c2, v1);
        }
        tally_chunk(x, w, c, a0, v0, att, ret, anyw);
        if (two) tally_chunk(x, w, c2, a1, v1, att, ret, anyw);
    }
    any = anyw != 0u;
}

// MAJ_WARP_ROWS rows from r0, where every lane holds at most two chunks and
// K % 16 = 0 (rows of one mask row then read the same mask chunks): the
// mask chunks are loaded again only where the mask row changes.
MAJ_FN void warp_rows(const MajArgs& x, long long r0, int lane, int lanes, int att[],
                      int ret[], bool any[]) {
    long long m_prev = -1;
    uint32_t v0[4] = {0u, 0u, 0u, 0u}, v1[4] = {0u, 0u, 0u, 0u};
    for (int k = 0; k < MAJ_WARP_ROWS; k++) {
        const long long r = r0 + k;
        if (r >= x.R) break;
        const RowPos w = row_pos(x, r);
        const int c = lane, c2 = lane + lanes;
        if (w.m != m_prev) {
            if (c < w.chunks) mask_chunk(x, w, c, v0);
            if (c2 < w.chunks) mask_chunk(x, w, c2, v1);
            m_prev = w.m;
        }
        uint32_t a0[4], a1[4], anyw = 0u;
        att[k] = ret[k] = 0;
        if (c < w.chunks) load16(w.a0 + 16 * c, a0);
        if (c2 < w.chunks) load16(w.a0 + 16 * c2, a1);
        if (c < w.chunks) tally_chunk(x, w, c, a0, v0, att[k], ret[k], anyw);
        if (c2 < w.chunks) tally_chunk(x, w, c2, a1, v1, att[k], ret[k], anyw);
        any[k] = anyw != 0u;
    }
}

#if defined(__CUDACC__)

template <int NW>
__global__ void __launch_bounds__(TILE_THREADS) tile_kernel(const MajArgs x) {
    extern __shared__ uint4 smem4[];
    uint8_t* sm = (uint8_t*)smem4;
    __shared__ TileGeom geom;
    if (threadIdx.x == 0) geom = tile_geom(x, blockIdx.x);
    __syncthreads();
    const TileGeom t = geom;
    tile_stage(x, t, sm, threadIdx.x, TILE_THREADS);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    tile_rows<NW>(x, t, sm, threadIdx.x);
    __syncthreads();
    tile_store(x, t, sm, threadIdx.x, TILE_THREADS);
}

__global__ void __launch_bounds__(WARP_THREADS) warp_kernel(const MajArgs x) {
    const long long warp = (long long)blockIdx.x * (WARP_THREADS / 32) + threadIdx.x / 32;
    const long long r0 = warp * MAJ_WARP_ROWS;
    if (r0 >= x.R) return;  // whole warps leave together
    const int lane = threadIdx.x % 32;
    int att[MAJ_WARP_ROWS], ret[MAJ_WARP_ROWS];
    bool any[MAJ_WARP_ROWS];
    const int max_k = ((uintptr_t)x.a & 15) == 0 ? 16 * 64 : 16 * 63;  // <= 64 chunks a row
    if (MAJ_WARP_ROWS > 1 && x.K % 16 == 0 && x.K <= max_k) {
        warp_rows(x, r0, lane, 32, att, ret, any);
    } else {
        for (int k = 0; k < MAJ_WARP_ROWS; k++)
            if (r0 + k < x.R) warp_lane(x, r0 + k, lane, 32, att[k], ret[k], any[k]);
    }
#pragma unroll
    for (int k = 0; k < MAJ_WARP_ROWS; k++) {
        if (r0 + k >= x.R) break;
        int a = att[k], b = ret[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a += __shfl_xor_sync(0xFFFFFFFFu, a, off);
            b += __shfl_xor_sync(0xFFFFFFFFu, b, off);
        }
        const bool y = __any_sync(0xFFFFFFFFu, any[k]);
        if (lane == 0) x.out[r0 + k] = majority_of(a, b, y, x.f[r0 + k]);
    }
}

#ifndef MAJ_DOUBLE_BUFFER
#define MAJ_DOUBLE_BUFFER 0  // 1: resident blocks loop over tiles, staging the next while tallying
#endif

// A resident grid: each block stages its next tile into the other of two
// buffers (its own cp.async group) while it tallies and stores this one.
template <int NW>
__global__ void __launch_bounds__(TILE_THREADS) tile_kernel_db(const MajArgs x, long long tiles) {
    extern __shared__ uint4 smem4[];
    uint8_t* sm = (uint8_t*)smem4;
    const int bytes = tile_smem_bytes(x.K);  // one buffer: the second follows it
    __shared__ TileGeom geom[2];
    long long t = blockIdx.x;
    if (threadIdx.x == 0) geom[0] = tile_geom(x, t);
    __syncthreads();
    tile_stage(x, geom[0], sm, threadIdx.x, TILE_THREADS);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    int b = 0;
    for (; t < tiles; t += gridDim.x) {
        const long long nt = t + gridDim.x;
        if (nt < tiles) {
            if (threadIdx.x == 0) geom[b ^ 1] = tile_geom(x, nt);
            __syncthreads();
            tile_stage(x, geom[b ^ 1], sm + (b ^ 1) * bytes, threadIdx.x, TILE_THREADS);
            asm volatile("cp.async.commit_group;\n" ::: "memory");
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const TileGeom g = geom[b];
        tile_rows<NW>(x, g, sm + b * bytes, threadIdx.x);
        __syncthreads();
        tile_store(x, g, sm + b * bytes, threadIdx.x, TILE_THREADS);
        __syncthreads();
        b ^= 1;
    }
}

template <int NW>
static void launch_tile(const MajArgs& x, long long tiles, cudaStream_t stream) {
    if (MAJ_DOUBLE_BUFFER) {
        const int smem = 2 * tile_smem_bytes(x.K);
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(tile_kernel_db<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_kernel_db<NW>, TILE_THREADS,
                                                      smem);
        const long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
        tile_kernel_db<NW><<<(unsigned)(tiles < grid ? tiles : grid), TILE_THREADS, smem,
                             stream>>>(x, tiles);
        return;
    }
    tile_kernel<NW><<<(unsigned)tiles, TILE_THREADS, tile_smem_bytes(x.K), stream>>>(x);
}

#endif

// The launch's arguments, or false for a shape the kernels do not take: S
// and P below 2^30 and R below 2^31 (row positions by 32-bit FastDiv).  -> tiles (K <= 32) or blocks of WARP_THREADS / 32
// rows.
MAJ_FN bool maj_args(long long R, int K, long long S, long long P, const void* answers,
                     const void* valid, const void* fallback, void* out, MajArgs& x,
                     long long& blocks) {
    if (K < 1 || S < 1 || P < 1 || S >= (1ll << 30) || P >= (1ll << 30) || R >= (1ll << 31))
        return false;
    x.R = R;
    x.S = S;
    x.P = P;
    x.K = K;
    x.fd_p = fast_div((uint32_t)P);
    x.fd_s = fast_div((uint32_t)S);
    x.tail = K % 4 ? (1u << (8 * (K % 4))) - 1u : 0xFFFFFFFFu;
    x.a = (const uint8_t*)answers;
    x.v = (const uint8_t*)valid;
    x.f = (const int8_t*)fallback;
    x.out = (int8_t*)out;
    if (K > TILE_MAX_K) {
        x.mode = TILE_LINEAR;
        x.tiles_a_run = 0;
        const long long rows_a_block = (WARP_THREADS / 32) * MAJ_WARP_ROWS;
        blocks = (R + rows_a_block - 1) / rows_a_block;
        return true;
    }
    if (S == 1 || 4 * P <= TILE_ROWS) {
        x.mode = TILE_LINEAR;
        x.tiles_a_run = 0;
        blocks = (R + TILE_ROWS - 1) / TILE_ROWS;
    } else {
        x.mode = TILE_IN_RUN;
        x.tiles_a_run = (P + TILE_ROWS - 1) / TILE_ROWS;
        blocks = R / P * x.tiles_a_run;
    }
    return true;
}

#if defined(__CUDACC__)

extern "C" int ba_majority(long long R, int K, long long S, long long P, const void* answers,
                           const void* valid, const void* fallback, void* out, void* stream) {
    if (R <= 0) return 0;
    MajArgs x;
    long long blocks;
    if (!maj_args(R, K, S, P, answers, valid, fallback, out, x, blocks))
        return (int)cudaErrorInvalidValue;
    const auto st = (cudaStream_t)stream;
    if (K > TILE_MAX_K) {
        warp_kernel<<<(unsigned)blocks, WARP_THREADS, 0, st>>>(x);
        return (int)cudaGetLastError();
    }
    switch ((K + 3) / 4) {
        case 1: launch_tile<1>(x, blocks, st); break;
        case 2: launch_tile<2>(x, blocks, st); break;
        case 3: launch_tile<3>(x, blocks, st); break;
        case 4: launch_tile<4>(x, blocks, st); break;
        case 5: launch_tile<5>(x, blocks, st); break;
        case 6: launch_tile<6>(x, blocks, st); break;
        case 7: launch_tile<7>(x, blocks, st); break;
        default: launch_tile<8>(x, blocks, st); break;
    }
    return (int)cudaGetLastError();
}

#endif

// ---- the first port's design ------------------------------------------

struct v1_Tally {
    int att, ret, elig;
};

MAJ_FN int v1_popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no carry
// crosses a byte, Hacker's Delight 6-1).
MAJ_FN uint32_t v1_zero_bytes(uint32_t x) {
    const uint32_t y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
    return ~(y | x | 0x7F7F7F7Fu);
}

// Four answers and four mask bytes (any non-zero mask byte is valid).
MAJ_FN void v1_tally_word(uint32_t a, uint32_t v, v1_Tally& t) {
    const uint32_t valid = ~v1_zero_bytes(v) & 0x80808080u;
    t.att += v1_popc32(v1_zero_bytes(a ^ 0x01010101u) & valid);
    t.ret += v1_popc32(v1_zero_bytes(a) & valid);
    t.elig += v1_popc32(valid);
}

MAJ_FN void v1_tally_byte(uint8_t a, uint8_t v, v1_Tally& t) {
    if (v) {
        t.att += a == 1;
        t.ret += a == 0;
        t.elig += 1;
    }
}

// Lane `lane` of `lanes` on one row: words lane, lane + lanes, ... when
// `words`, else bytes.
MAJ_FN v1_Tally v1_tally_lane(const uint8_t* a, const uint8_t* v, int K, bool words, int lane,
                        int lanes) {
    v1_Tally t = {0, 0, 0};
    if (words) {
        const uint32_t* aw = (const uint32_t*)a;
        const uint32_t* vw = (const uint32_t*)v;
        for (int w = lane; w < K / 4; w += lanes) v1_tally_word(aw[w], vw[w], t);
    } else {
        for (int k = lane; k < K; k += lanes) v1_tally_byte(a[k], v[k], t);
    }
    return t;
}

MAJ_FN int8_t v1_majority_of(v1_Tally t, int8_t fallback) {
    if (t.elig == 0) return fallback;
    return t.att > t.ret ? 1 : (t.ret > t.att ? 0 : 2);
}

// The mask row that answer row r reads.
MAJ_FN int64_t v1_mask_row(int64_t r, int64_t S, int64_t P) {
    return (r / (S * P)) * P + r % P;
}

#if defined(__CUDACC__)

constexpr int v1_THREADS = 256;

__global__ void __launch_bounds__(v1_THREADS) v1_majority_row_kernel(
    int64_t R, int K, int64_t S, int64_t P, bool words, const uint8_t* __restrict__ answers,
    const uint8_t* __restrict__ valid, const int8_t* __restrict__ fallback,
    int8_t* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * v1_THREADS + threadIdx.x;
    if (r >= R) return;
    const v1_Tally t = v1_tally_lane(answers + r * K, valid + v1_mask_row(r, S, P) * K, K, words, 0, 1);
    out[r] = v1_majority_of(t, fallback[r]);
}

__global__ void __launch_bounds__(v1_THREADS) v1_majority_warp_kernel(
    int64_t R, int K, int64_t S, int64_t P, bool words, const uint8_t* __restrict__ answers,
    const uint8_t* __restrict__ valid, const int8_t* __restrict__ fallback,
    int8_t* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * (v1_THREADS / 32) + threadIdx.x / 32;
    if (r >= R) return;  // whole warps leave together: r is the warp's
    const int lane = threadIdx.x % 32;
    v1_Tally t = v1_tally_lane(answers + r * K, valid + v1_mask_row(r, S, P) * K, K, words, lane, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        t.att += __shfl_xor_sync(0xFFFFFFFFu, t.att, off);
        t.ret += __shfl_xor_sync(0xFFFFFFFFu, t.ret, off);
        t.elig += __shfl_xor_sync(0xFFFFFFFFu, t.elig, off);
    }
    if (lane == 0) out[r] = v1_majority_of(t, fallback[r]);
}

// Rows of fewer than v1_WARP_MIN_K answers are a thread's, longer rows a warp's.
constexpr int v1_WARP_MIN_K = 33;

extern "C" int v1_ba_majority(long long R, int K, long long S, long long P, const void* answers,
                           const void* valid, const void* fallback, void* out, void* stream) {
    if (R <= 0) return 0;
    const bool words = K % 4 == 0 && ((uintptr_t)answers % 4 == 0) && ((uintptr_t)valid % 4 == 0);
    const auto* a = (const uint8_t*)answers;
    const auto* v = (const uint8_t*)valid;
    const auto* f = (const int8_t*)fallback;
    auto* o = (int8_t*)out;
    if (K < v1_WARP_MIN_K) {
        const long long blocks = (R + v1_THREADS - 1) / v1_THREADS;
        v1_majority_row_kernel<<<(unsigned)blocks, v1_THREADS, 0, (cudaStream_t)stream>>>(
            R, K, S, P, words, a, v, f, o);
    } else {
        const long long blocks = (R + v1_THREADS / 32 - 1) / (v1_THREADS / 32);
        v1_majority_warp_kernel<<<(unsigned)blocks, v1_THREADS, 0, (cudaStream_t)stream>>>(
            R, K, S, P, words, a, v, f, o);
    }
    return (int)cudaGetLastError();
}

#endif
