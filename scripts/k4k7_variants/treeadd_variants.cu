// Variants of K4 (ba_tpu_torch/ops/csrc/treeadd.cu) that
// scripts/k4k7_variants.py builds and times, beside the shipped design
// (the defaults of the flags below): the same lane code, with the table's
// home, the digit-0 entry, ref10's layout and the launch bounds as -D
// flags.  These lost on an H100 (PERF.md, the K4 and K7 redesign).
//
// K4's variants: the fixed-base product [S]B from a table of signed 4-bit windows in
// the kernels' own limb form; FB_T threads a lane (1, 2, 4 or 8).
//
// Replaces ba_tpu/ops/treeadd.py::_tree8_kernel (the Pallas TPU kernel),
// which folds the 64 window points of a lane in two grid levels of an
// 8-to-1 tree, and the one-hot gather that feeds it, which the reference
// leaves to XLA (ba_tpu/crypto/ed25519.py:162-192): this kernel gathers
// its points itself from the window table in device memory.
//
// Recoding.  S, 32 little-endian bytes, is recoded on the fly into 64
// signed digits in [-8, 8), low digit first with a carry: u = S + 8 in
// every 4-bit window (eight 32-bit words, one addition chain), digit i is
// nibble i of u less 8, and the carry out of the top, c in {0, 1}, is a
// 65th digit of weight 16^64 = 2^256.  S = sum_i d_i 16^i + c 2^256, so
// [S]B = sum_i [d_i 16^i]B + [c 2^256]B for any 32-byte S (S >= L too).
//
// Table (crypto/ed25519.py fixed_base_table): row w < 64 holds [j 16^w]B
// for j = 1..8, row 64 [j 2^256]B; each entry is the cached form at
// Z = 1, (Y - X, Y + X, 2d T), 10 canonical limbs each, then 2 zero words
// (128 B, read as 16-byte loads), 66 560 B in all.  No byte is decoded.
// Digit d reads entry |d| - 1; d < 0 swaps Y - X and Y + X and negates
// 2d T; d = 0 selects (1, 1, 0), the identity.
//
// Fold order, the same bits for every FB_T: group g (g = 0..7) sums
// windows 8g .. 8g + 7 in window order, the first entry turned into a
// point (ge_from_affine: 1 multiply) and each next one added by the mixed
// addition (ge_add_affine: 7 multiplies); group 7 adds row 64's digit c
// last.  A balanced tree of complete additions then folds the 8 partials,
// ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)), the reference's second level
// (ba_tpu/ops/treeadd.py:9-14).  Thread `part` of FB_T computes the
// subtree over groups [part 8/FB_T, (part + 1) 8/FB_T) itself, and
// log2 FB_T warp-shuffle levels add the rest, the lower partner of each
// pair adding the upper one's sum.  The wrapper picks FB_T from S
// (ops/treeadd.py THREADS_BY_LANES, as measured): 8 threads for one lane,
// 2 at 10 240, 4 at 20 480, 1 at 65 536.
//
// Bound: operations: 8 x 1 + 57 x 7 + 7 x 9 = 470 multiplies a lane.
// Bytes: 32 in, 128 out a lane; the table stays in L2 and L1.
//
// The design was chosen on an H100 among the variants below
// (scripts/k4k7_variants.py, weighted by the paths' launches, config #3's
// own S at 65 536 lanes): the table in shared memory ran up to 30 %
// slower, the identity entry tied the select or lost, ref10's layout lost
// by 20-25 % at 65 536 lanes, and launch bounds asking for 3 or 4 blocks
// a SM lost (spill).  A thread's subtree is a loop over its groups with a
// counter of pending partials (fb_subtree): inlined as a recursion, the
// eight groups' code took 255 registers and spilled at T = 1 and 2, ran
// 3-20 % slower and compiled in 97 s instead of 25.
//
// The build's -D flags pick the variant (the defaults are the shipped
// design): FB_SHARED 1 copies the table into shared memory once a block,
// with entries 36 words apart (16-byte aligned; eight entries of one row
// fall in eight bank groups) and a grid of as many blocks as stay
// resident, each looping over lanes; FB_ZERO_ENTRY 1 reads a table of 9
// entries a row, the 9th the identity, for d = 0 instead of the select;
// FB_REF10 1 runs ref10's layout at one thread a lane, reading the even
// rows only: [S]B = sum of even windows + 16 (sum of odd windows, each
// from the row below it), 4 doublings more, another fold (the same
// point, other coordinates); FB_MIN_BLOCKS asks every instance's
// __launch_bounds__ for that many blocks a SM.
//
// Interface: s uint8 [n, 32], table int32 [65, 8, 32] (9 entries a row
// under FB_ZERO_ENTRY) -> out uint8 [n, 4, 32], canonical.

#include "ed25519_field.cuh"

#ifndef FB_SHARED
#define FB_SHARED 0
#endif
#ifndef FB_ZERO_ENTRY
#define FB_ZERO_ENTRY 0
#endif
#ifndef FB_BLOCK
#define FB_BLOCK 128
#endif
#ifndef FB_REF10
#define FB_REF10 0
#endif
// FB_MIN_BLOCKS: the blocks a SM that __launch_bounds__ asks of every
// instance (unset: none asked, ptxas's own choice).
#ifdef FB_MIN_BLOCKS
#define FB_BOUNDS __launch_bounds__(FB_BLOCK, FB_MIN_BLOCKS)
#else
#define FB_BOUNDS __launch_bounds__(FB_BLOCK)
#endif

constexpr int FB_WINDOWS = 64;                  // 4-bit windows of a 32-byte S
constexpr int FB_ROWS = FB_WINDOWS + 1;         // and the carry's row
constexpr int FB_ENTRIES = 8 + FB_ZERO_ENTRY;   // [1..8] 16^w B (and the identity)
constexpr int FB_ENTRY_WORDS = 32;              // 30 limbs and 2 zero words
constexpr int FB_GROUPS = 8;                    // the tree's leaves, 8 windows each
constexpr int FB_SHARED_ENTRY_WORDS = 36;       // an entry's stride in shared memory

struct gca {  // a table entry: (Y - X, Y + X, 2d T) at Z = 1
    fe ymx, ypx, t2d;
};

// One entry's 30 words from e (16-byte aligned), through the read-only
// path when GLOBAL.
template <bool GLOBAL>
ED_FN void fb_load(gca& q, const int32_t* e) {
    int32_t* dst = &q.ymx.v[0];
#if defined(__CUDACC__)
    const int4* src = reinterpret_cast<const int4*>(e);
#pragma unroll
    for (int i = 0; i < 7; i++) {
        const int4 v = GLOBAL ? __ldg(src + i) : src[i];
        dst[4 * i] = v.x;
        dst[4 * i + 1] = v.y;
        dst[4 * i + 2] = v.z;
        dst[4 * i + 3] = v.w;
    }
    const int2 v = GLOBAL ? __ldg(reinterpret_cast<const int2*>(e + 28))
                          : *reinterpret_cast<const int2*>(e + 28);
    dst[28] = v.x;
    dst[29] = v.y;
#else
    for (int i = 0; i < 30; i++) dst[i] = e[i];
#endif
}

// The entry for digit d in [-8, 8] of a row whose entries lie ESTRIDE
// words apart: [|d| 16^w]B, negated for d < 0, the identity for d = 0.
template <bool GLOBAL, int ESTRIDE>
ED_FN void fb_lookup(gca& q, const int32_t* row, int d) {
    const int mag = d < 0 ? -d : d;
    const bool neg = d < 0, zero = d == 0;
    fb_load<GLOBAL>(q, row + ESTRIDE * (zero ? FB_ENTRIES - 1 : mag - 1));
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t m = q.ymx.v[i], p = q.ypx.v[i], t = q.t2d.v[i];
        q.ymx.v[i] = neg ? p : m;
        q.ypx.v[i] = neg ? m : p;
        q.t2d.v[i] = neg ? -t : t;
        if (!FB_ZERO_ENTRY) {
            q.ymx.v[i] = zero ? (i == 0) : q.ymx.v[i];
            q.ypx.v[i] = zero ? (i == 0) : q.ypx.v[i];
            q.t2d.v[i] = zero ? 0 : q.t2d.v[i];
        }
    }
}

// r = p + q for a table entry q (Z = 1): add-2008-hwcd-3 with Y2 - X2,
// Y2 + X2 and 2d T2 read from q and 2 Z1 Z2 = 2 Z1, 7 multiplies; the
// values of ge_add(p, (x, y, 1, x y)).  Bounds (header comment): p's X
// and Y may be ge_from_affine's (u < 4), so Y1 - X1 has u < 8, against
// q's canonical u < 1.
ED_FN void ge_add_affine(ge& r, const ge& p, const gca& q) {
    fe a, b, c, d, e, f, g, h, s;
    fe_sub(s, p.y, p.x);
    fe_mul(a, s, q.ymx);
    fe_add(s, p.y, p.x);
    fe_mul(b, s, q.ypx);
    fe_mul(c, p.t, q.t2d);
    fe_dbl(d, p.z);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    fe_mul(r.t, e, h);
}

// The identity plus q, 1 multiply: with E = (Y + X) - (Y - X) and
// H = (Y + X) + (Y - X), ge_add_affine(identity, q) is (2E, 2H, 4, E H).
ED_FN void ge_from_affine(ge& r, const gca& q) {
    fe e, h;
    fe_sub(e, q.ypx, q.ymx);
    fe_add(h, q.ypx, q.ymx);
    fe_mul(r.t, e, h);
    fe_dbl(r.x, e);
    fe_dbl(r.y, h);
    fe_0(r.z);
    r.z.v[0] = 4;
}

// The recoded scalar: u = S + 0x88..8 in eight words (digit i is nibble i
// of u less 8); returns the carry out of the top, the 65th digit.
ED_FN int fb_recode(uint32_t u[8], const uint8_t* s) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        const uint32_t w = (uint32_t)s[4 * j] | (uint32_t)s[4 * j + 1] << 8 |
                           (uint32_t)s[4 * j + 2] << 16 | (uint32_t)s[4 * j + 3] << 24;
        const uint64_t t = (uint64_t)w + 0x88888888u + carry;
        u[j] = (uint32_t)t;
        carry = (uint32_t)(t >> 32);
    }
    return (int)carry;
}

// u[j] by selects, so that u stays in registers.
ED_FN uint32_t fb_word(const uint32_t* u, int j) {
    uint32_t word = u[0];
#pragma unroll
    for (int k = 1; k < 8; k++) word = j == k ? u[k] : word;
    return word;
}

// Group g's partial: windows 8g .. 8g + 7 (their digits, nibbles of word
// u[g]) in window order, and the carry's row after group 7's.
template <bool GLOBAL, int ESTRIDE>
ED_FN void fb_group(ge& acc, const int32_t* table, const uint32_t* u, int carry, int g) {
    constexpr int ROW = FB_ENTRIES * ESTRIDE;
    const uint32_t word = fb_word(u, g);
    gca q;
    fb_lookup<GLOBAL, ESTRIDE>(q, table + 8 * g * ROW, (int)(word & 15u) - 8);
    ge_from_affine(acc, q);
#pragma unroll 1
    for (int j = 1; j < 8; j++) {
        fb_lookup<GLOBAL, ESTRIDE>(q, table + (8 * g + j) * ROW, (int)((word >> (4 * j)) & 15u) - 8);
        ge_add_affine(acc, acc, q);
    }
    if (g == FB_GROUPS - 1) {
        fb_lookup<GLOBAL, ESTRIDE>(q, table + FB_WINDOWS * ROW, carry);
        ge_add_affine(acc, acc, q);
    }
}

// The balanced tree over groups g0 .. g0 + G - 1 (G a power of 2), the
// groups in order: a binary counter of pending partials, partial k merged
// (left + right) once for each trailing one bit of k.  One copy of the
// group's code, so the four instances compile quickly.
template <int G, bool GLOBAL, int ESTRIDE>
ED_FN void fb_subtree(ge& out, const int32_t* table, const uint32_t* u, int carry, int g0) {
    ge pending[G > 1 ? 3 : 1];
    int top = 0;
#pragma unroll 1
    for (int k = 0; k < G; k++) {
        fb_group<GLOBAL, ESTRIDE>(out, table, u, carry, g0 + k);
#pragma unroll 1
        for (int m = 1; k & m; m <<= 1) ge_add(out, pending[--top], out);
        if (k + 1 < G) pending[top++] = out;
    }
}

// Thread `part` of T's share of a lane: the subtree over its 8 / T groups.
template <int T, bool GLOBAL, int ESTRIDE>
ED_FN void fb_part(ge& out, const int32_t* table, const uint8_t* s, int part) {
    uint32_t u[8];
    const int carry = fb_recode(u, s);
    fb_subtree<FB_GROUPS / T, GLOBAL, ESTRIDE>(out, table, u, carry, part * (FB_GROUPS / T));
}

// ref10's layout (FB_REF10): odd windows from the row below, times 16,
// then the even windows and the carry's row.
ED_FN void fb_ref10_lane(ge& acc, const int32_t* table, const uint8_t* s) {
    constexpr int ROW = FB_ENTRIES * FB_ENTRY_WORDS;
    uint32_t u[8];
    const int carry = fb_recode(u, s);
    gca q;
#pragma unroll 1
    for (int i = 1; i < FB_WINDOWS; i += 2) {
        const int d = (int)((fb_word(u, i >> 3) >> (4 * (i & 7))) & 15u) - 8;
        fb_lookup<true, FB_ENTRY_WORDS>(q, table + (i - 1) * ROW, d);
        if (i == 1)
            ge_from_affine(acc, q);
        else
            ge_add_affine(acc, acc, q);
    }
#pragma unroll
    for (int i = 0; i < 4; i++) ge_dbl(acc, acc, i == 3);
#pragma unroll 1
    for (int i = 0; i < FB_WINDOWS; i += 2) {
        const int d = (int)((fb_word(u, i >> 3) >> (4 * (i & 7))) & 15u) - 8;
        fb_lookup<true, FB_ENTRY_WORDS>(q, table + i * ROW, d);
        ge_add_affine(acc, acc, q);
    }
    fb_lookup<true, FB_ENTRY_WORDS>(q, table + FB_WINDOWS * ROW, carry);
    ge_add_affine(acc, acc, q);
}

#if defined(__CUDACC__)

__device__ __forceinline__ void ge_shfl_xor(ge& h, const ge& f, int m) {
    const int32_t* src = &f.x.v[0];
    int32_t* dst = &h.x.v[0];
#pragma unroll
    for (int i = 0; i < 40; i++) dst[i] = __shfl_xor_sync(0xffffffffu, src[i], m);
}

// Lane gt / T, part gt % T: its subtree, then the shuffle levels.  Threads
// past the last lane fold lane n - 1 too (every thread of a warp takes
// part in the shuffles) and write nothing.
template <int T, bool GLOBAL, int ESTRIDE>
__device__ __forceinline__ void fb_thread(int n, long gt, const uint8_t* s_enc,
                                          const int32_t* table, uint8_t* out) {
    const long lane = gt / T;
    const int part = (int)(gt % T);
    if (T == 1 && lane >= n) return;
    const long src = lane < n ? lane : n - 1;
    ge acc;
    fb_part<T, GLOBAL, ESTRIDE>(acc, table, s_enc + 32 * src, part);
#pragma unroll
    for (int m = 1; m < T; m <<= 1) {
        ge other;
        ge_shfl_xor(other, acc, m);
        if ((part & (2 * m - 1)) == 0) ge_add(acc, acc, other);
    }
    if (part == 0 && lane < n) ge_tobytes4(out + 128 * lane, acc);
}

// A block of FB_BLOCK threads, or of the warps T n threads fill when fewer.
static int fb_block(int T, int n) {
    const long warps = ((long)T * n + 31) / 32;
    return warps * 32 < FB_BLOCK ? (int)(warps * 32) : FB_BLOCK;
}

#if FB_SHARED
template <int T>
__global__ void FB_BOUNDS fixed_base_kernel(int n, const uint8_t* __restrict__ s_enc,
                                                              const int32_t* __restrict__ table,
                                                              uint8_t* __restrict__ out) {
    extern __shared__ int4 fb_smem[];
    int32_t* tab = reinterpret_cast<int32_t*>(fb_smem);
    const int4* src = reinterpret_cast<const int4*>(table);
    constexpr int CHUNKS = FB_ENTRY_WORDS / 4;
    for (int i = threadIdx.x; i < FB_ROWS * FB_ENTRIES * CHUNKS; i += blockDim.x)
        fb_smem[(i / CHUNKS) * (FB_SHARED_ENTRY_WORDS / 4) + i % CHUNKS] = __ldg(src + i);
    __syncthreads();
    const long total = (long)T * n;
    for (long base = (long)blockIdx.x * blockDim.x; base < total; base += (long)gridDim.x * blockDim.x)
        fb_thread<T, false, FB_SHARED_ENTRY_WORDS>(n, base + threadIdx.x, s_enc, tab, out);
}

constexpr size_t FB_SMEM_BYTES = sizeof(int32_t) * FB_ROWS * FB_ENTRIES * FB_SHARED_ENTRY_WORDS;

template <int T>
static int fb_launch(int n, const uint8_t* s, const int32_t* table, uint8_t* out,
                     cudaStream_t stream) {
    static int blocks_per_sm = 0, sms = 0;
    if (!blocks_per_sm) {
        int dev = 0;
        cudaError_t err = cudaFuncSetAttribute(fixed_base_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)FB_SMEM_BYTES);
        if (err == cudaSuccess) err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, fixed_base_kernel<T>,
                                                                FB_BLOCK, FB_SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        if (!blocks_per_sm) return (int)cudaErrorInvalidConfiguration;
    }
    const long need = ((long)T * n + FB_BLOCK - 1) / FB_BLOCK;
    const long grid = need < (long)blocks_per_sm * sms ? need : (long)blocks_per_sm * sms;
    fixed_base_kernel<T><<<(unsigned)grid, fb_block(T, n), FB_SMEM_BYTES, stream>>>(n, s, table,
                                                                                    out);
    return (int)cudaGetLastError();
}
#else
template <int T>
__global__ void FB_BOUNDS fixed_base_kernel(int n, const uint8_t* __restrict__ s_enc,
                                                              const int32_t* __restrict__ table,
                                                              uint8_t* __restrict__ out) {
    const long gt = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (FB_REF10 && T == 1) {
        if (gt >= n) return;
        ge acc;
        fb_ref10_lane(acc, table, s_enc + 32 * gt);
        ge_tobytes4(out + 128 * gt, acc);
        return;
    }
    fb_thread<T, true, FB_ENTRY_WORDS>(n, gt, s_enc, table, out);
}

template <int T>
static int fb_launch(int n, const uint8_t* s, const int32_t* table, uint8_t* out,
                     cudaStream_t stream) {
    const long grid = ((long)T * n + FB_BLOCK - 1) / FB_BLOCK;
    fixed_base_kernel<T><<<(unsigned)grid, fb_block(T, n), 0, stream>>>(n, s, table, out);
    return (int)cudaGetLastError();
}
#endif

extern "C" int ba_fixed_base(int n, int threads_per_lane, const void* s_enc, const void* table,
                             void* out, void* stream) {
    if (n <= 0) return 0;
    const uint8_t* s = (const uint8_t*)s_enc;
    const int32_t* tab = (const int32_t*)table;
    uint8_t* o = (uint8_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (threads_per_lane) {
        case 1: return fb_launch<1>(n, s, tab, o, st);
        case 2: return fb_launch<2>(n, s, tab, o, st);
        case 4: return fb_launch<4>(n, s, tab, o, st);
        case 8: return fb_launch<8>(n, s, tab, o, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

#endif
