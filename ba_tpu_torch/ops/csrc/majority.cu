// K9: the masked strict majority with a fallback: rows of K <= 32 by tiles
// of consecutive rows staged in shared memory, longer rows one a warp.
//
// Replaces ba_tpu/ops/majority.py::_majority_kernel (the Pallas TPU kernel,
// through masked_majority_rows): for each row, count ATTACK (1) and RETREAT
// (0) answers over the valid responders and emit ATTACK or RETREAT by strict
// majority, UNDEFINED (2) on a tie, and the row's fallback when no responder
// is valid.  Any other int8 answer is eligible but counts for neither; any
// non-zero mask byte is valid.  Every EIG resolve level is one launch
// (core/eig.py::_resolve_from).
//
// Layout: answers int8 [G, S, P, K] (R = G S P rows), valid bool [G, P, K]
// (row (g, s, p) reads mask row (g, p): S = 1 and P = R is the dense [R, K]
// form), fallback int8 [R] -> out int8 [R].
//
// Bound: bytes (each input byte read once, each output byte written once).
// At K = 10 (config #2) a row is 10 answer bytes, a share of a mask row and
// two bytes more, so the tally's instructions a row are what can keep the
// card off that bound.  The design:
// - Rows of K <= 32 (tile_kernel<NW>, NW = ceil(K / 4) words a row): a
//   block owns TILE_ROWS consecutive rows.  Their answer bytes, their
//   fallback bytes and the mask rows the tile reads are each one contiguous
//   run, staged into shared memory by 16-byte cp.async copies of the
//   aligned chunks that overlap the run (a chunk that holds a byte of a
//   tensor lies inside its allocation, which is 16-byte aligned).  A thread
//   then tallies ROWS_A_THREAD consecutive rows from shared memory as
//   32-bit words realigned by funnel shifts (any K, any base alignment),
//   four answers a word by SWAR (flag_word), the words' flags packed into
//   one word before two popcounts.  Results go to shared memory and out in
//   16-byte stores.  Row positions (g, s, p) come from the block's first
//   row (in thread 0) and its own first row (FastDiv: a multiply and a
//   shift for a 32-bit division), then step by one a row.
//   Tiles are runs of consecutive rows when S = 1 (the mask rows are the
//   rows) or P <= TILE_ROWS / 4 (the mask rows of the g it touches, at
//   most TILE_ROWS); else each tile stays inside one (g, s) run of P rows.
// - Rows of K >= 33 (warp_kernel): a warp a row; lane l reads the row's
//   16-byte aligned chunks l, l + 32, ... (512 bytes a warp instruction),
//   the mask's matching 16 bytes (one aligned load where the two rows
//   agree mod 16, else two, realigned), bytes outside the row masked off;
//   the counts summed by shuffles.  A shared mask row is read by the S rows
//   of its instance and comes from cache.
//
// The tally functions compile as host C++ too (MAJ_FN is `static inline`
// without nvcc), so tests/torch_csrc_host.cpp replays both kernels,
// tile by tile and lane by lane, off the card.

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

constexpr int TILE_THREADS = 128;
constexpr int ROWS_A_THREAD = 4;
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

// A row's flags: word j's ATTACK and RETREAT flags (0x80 a byte) shifted
// right by j (j < 8 keeps them apart), and any valid byte.  The byte tests
// are exact SWAR (no carry crosses a byte, Hacker's Delight 6-1).
struct Flags {
    uint32_t att, ret, any;
};

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
#if defined(__CUDA_ARCH__)
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
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

// Where row r's answers and mask row lie, and its answer chunks.
struct RowPos {
    const uint8_t* arow;
    const uint8_t* vrow;
    const uint8_t* a0;  // the row's first aligned chunk
    long long delta;    // mask byte of answer byte y: y + delta
    int vsh, chunks;
};

MAJ_FN RowPos row_pos(const MajArgs& x, long long r) {
    RowPos w;
    const uint32_t q = div_by((uint32_t)r, x.fd_p);
    const long long p = r - (long long)q * x.P;
    const long long m = (long long)div_by(q, x.fd_s) * x.P + p;
    w.arow = x.a + r * x.K;
    w.vrow = x.v + m * x.K;
    w.a0 = (const uint8_t*)((uintptr_t)w.arow & ~(uintptr_t)15);
    w.delta = w.vrow - w.arow;
    w.vsh = (int)((uintptr_t)(w.a0 + w.delta) & 15);  // the same for every chunk
    w.chunks = (int)((w.arow + x.K - w.a0 + 15) >> 4);
    return w;
}

// The mask's 16 bytes matching answer chunk c: one aligned load where the
// two rows agree mod 16, else the two aligned chunks it spans (each only
// where it holds some of the row's mask bytes), realigned.
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

// Lane `lane` of `lanes` on row r: its chunks lane, lane + lanes, ...;
// bytes of a chunk outside the row count for nothing.
MAJ_FN void warp_lane(const MajArgs& x, long long r, int lane, int lanes, int& att, int& ret,
                      bool& any) {
    const RowPos w = row_pos(x, r);
    att = ret = 0;
    uint32_t anyw = 0u;
    for (int c = lane; c < w.chunks; c += lanes) {
        uint32_t a[4], v[4];
        load16(w.a0 + 16 * c, a);
        mask_chunk(x, w, c, v);
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
        anyw |= fl.any;
    }
    any = anyw != 0u;
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
    const long long r = (long long)blockIdx.x * (WARP_THREADS / 32) + threadIdx.x / 32;
    if (r >= x.R) return;  // whole warps leave together: r is the warp's
    const int lane = threadIdx.x % 32;
    int att, ret;
    bool any;
    warp_lane(x, r, lane, 32, att, ret, any);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        att += __shfl_xor_sync(0xFFFFFFFFu, att, off);
        ret += __shfl_xor_sync(0xFFFFFFFFu, ret, off);
    }
    any = __any_sync(0xFFFFFFFFu, any);
    if (lane == 0) x.out[r] = majority_of(att, ret, any, x.f[r]);
}

template <int NW>
static void launch_tile(const MajArgs& x, long long tiles, cudaStream_t stream) {
    tile_kernel<NW><<<(unsigned)tiles, TILE_THREADS, tile_smem_bytes(x.K), stream>>>(x);
}

#endif

// The launch's arguments, or false for a shape the kernels do not take: S
// and P below 2^30 and R below 2^31 (row positions by 32-bit FastDiv).  This
// is the one place that limit is set: ba_majority returns MAJ_UNSUPPORTED
// for such a shape, and the wrapper raises ValueError.  -> tiles (K <= 32)
// or blocks of WARP_THREADS / 32 rows.
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
        blocks = (R + WARP_THREADS / 32 - 1) / (WARP_THREADS / 32);
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

constexpr int MAJ_UNSUPPORTED = -1;  // a shape maj_args refuses; no CUDA error is negative

extern "C" int ba_majority(long long R, int K, long long S, long long P, const void* answers,
                           const void* valid, const void* fallback, void* out, void* stream) {
    if (R <= 0) return 0;
    MajArgs x;
    long long blocks;
    if (!maj_args(R, K, S, P, answers, valid, fallback, out, x, blocks))
        return MAJ_UNSUPPORTED;
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
