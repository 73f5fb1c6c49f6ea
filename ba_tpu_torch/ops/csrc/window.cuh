// The signed-window accumulator shared by K3 (window_verify.cu) and K3'
// (window_mult.cu): the Hopper design of ba_tpu/ops/ladder.py::_window_acc.
//
// acc = [k]P for the little-endian scalar k of NBYTES bytes, in signed
// digits of W = WBITS bits (WINDOW_BITS = 3 in the kernels).  Recoding,
// low digit first with a carry, is one addition a lane: k plus 2^(W-1)
// in every one of the NWIN = ceil(8 NBYTES / W) windows; window i of
// that sum, less 2^(W-1), is the digit d_i in [-2^(W-1), 2^(W-1)), and
// the carry out of the top window is one more digit, 0 or 1, with which
// acc starts (P or the identity).  Then NWIN windows, most significant
// first: W doublings (the dedicated formula, T only on the last) and one
// addition of [|d|]P, negated for d < 0, the identity for d = 0.  At
// W = 3: 86 windows at 32 bytes, 43 at 16.
//
// The table holds [1..2^(W-1)]P (2^(W-1) - 1 additions) in the cached
// form the addition reads, (Y - X, Y + X, 2d T, 2 Z): an addition is 8
// multiplies, not 9, and -P is the same entry with Y - X and Y + X
// swapped and 2d T negated.  It is indexed by the digit, so it does not
// sit in local memory, where a warp whose digits differ reads 32 lines a
// load.  It lives in shared memory, lane-major: word w of a lane at
// tab[w * STRIDE], tab the lane's column and STRIDE the block's lanes
// (32), so lane t always reads bank t and any mix of digits reads
// without a conflict.  On the host STRIDE is 1 and tab an array.
//
// Why W = 3: a lane's table is 640 B (20 kB a 32-lane block), so a SM
// holds 8 one-warp blocks, as many as 255 registers a thread allow.  At
// W = 4 the table is 1 280 B a lane, 40 kB a block, and shared memory
// holds a SM to 5 blocks: on an H100 that ran 10.5 ms at 65 536 lanes
// against 6.1 for W = 3, which does 8 % more work (scripts/
// k3p_variants.py, where both are built).
//
// Work a lane at W = 3: 3 additions of 8 and 4 multiplies by 2d for the
// table (28 multiplies), then a window 2 doublings of 4 multiplies and 3
// squarings, one of 5 and 3, and an addition of 8: 21 and 9.  The same
// X, Y, Z, T as ge_add on the extended entry (the same products), which
// is what ops/ladder.py's plain_window_acc computes.  NBYTES and WBITS
// are template parameters, so the window loop has a trip count known at
// compile time and the recoded scalar stays in registers.

#pragma once
#include "ed25519_field.cuh"

constexpr int WINDOW_BITS = 3;  // a lane's windows, on its own table (a warp's: below)
constexpr int GC_WORDS = 40;    // a cached point: 4 x 10 int32 limbs

struct gc {  // a point in cached form
    fe ymx, ypx, t2d, z2;
};

// Table words a lane for windows of WBITS bits.
template <int WBITS>
struct WindowTable {
    static constexpr int WORDS = GC_WORDS << (WBITS - 1);
};

ED_FN void ge_cached(gc& c, const ge& p) {
    fe d2;
    fe_sub(c.ymx, p.y, p.x);
    fe_add(c.ypx, p.y, p.x);
    fe_load(d2, FE_D2_LIMBS);
    fe_mul(c.t2d, p.t, d2);
    fe_dbl(c.z2, p.z);
}

// r = p + q, q cached: add-2008-hwcd-3 with Y2 - X2, Y2 + X2, 2d T2 and
// 2 Z2 read from q, 8 multiplies.  Operands stay inside fe_mul's bound:
// q's terms are sums of two carried or canonical values (u <= 2).
ED_FN void ge_add_cached(ge& r, const ge& p, const gc& q) {
    fe a, b, c, d, e, f, g, h, s;
    fe_sub(s, p.y, p.x);
    fe_mul(a, s, q.ymx);
    fe_add(s, p.y, p.x);
    fe_mul(b, s, q.ypx);
    fe_mul(c, p.t, q.t2d);
    fe_mul(d, p.z, q.z2);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    fe_mul(r.t, e, h);
}

// Table addressing: word i of entry e at tab[(ESTRIDE e + i) STRIDE].
template <int STRIDE, int ESTRIDE>
ED_FN void gc_store(int32_t* tab, int entry, const gc& c) {
    const int32_t* src = &c.ymx.v[0];
#pragma unroll
    for (int i = 0; i < GC_WORDS; i++) tab[(ESTRIDE * entry + i) * STRIDE] = src[i];
}

template <int STRIDE, int ESTRIDE>
ED_FN void gc_load(gc& c, const int32_t* tab, int entry) {
    int32_t* dst = &c.ymx.v[0];
#pragma unroll
    for (int i = 0; i < GC_WORDS; i++) dst[i] = tab[(ESTRIDE * entry + i) * STRIDE];
}

// The entry for digit d: [|d|]P, negated for d < 0, the identity
// (1, 1, 0, 2) for d = 0; selects, not branches.
template <int STRIDE, int ESTRIDE>
ED_FN void gc_lookup(gc& q, const int32_t* tab, int d) {
    const int mag = d < 0 ? -d : d;
    gc_load<STRIDE, ESTRIDE>(q, tab, mag > 0 ? mag - 1 : 0);
    const bool neg = d < 0, zero = d == 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t m = q.ymx.v[i], p = q.ypx.v[i], t = q.t2d.v[i], one = i == 0 ? 1 : 0;
        q.ymx.v[i] = zero ? one : (neg ? p : m);
        q.ypx.v[i] = zero ? one : (neg ? m : p);
        q.t2d.v[i] = zero ? 0 : (neg ? -t : t);
        q.z2.v[i] = zero ? 2 * one : q.z2.v[i];
    }
}

// The shape of the recoded scalar: NWIN windows of WBITS bits below the
// carry digit, held in WORDS 32-bit words shifted up by SHIFT so that
// window NWIN - 1 is the top of the last word.
template <int NBYTES, int WBITS>
struct Recoding {
    static constexpr int NWIN = (8 * NBYTES + WBITS - 1) / WBITS;
    static constexpr int BITS = WBITS * NWIN;
    static constexpr int WORDS = (BITS + 31) / 32;
    static constexpr int SHIFT = 32 * WORDS - BITS;
};

// Word j of the recoding's bias: 2^(W-1) in each of the windows below BITS.
template <int BITS, int WBITS>
ED_FN uint32_t recode_bias(int j) {
    uint32_t w = 0;
#pragma unroll
    for (int t = 0; t < 32; t++) {
        const int b = 32 * j + t;
        if (b < BITS && b % WBITS == WBITS - 1) w |= 1u << t;
    }
    return w;
}

// Shifts the words u[0..WORDS) up by s bits (0 < s < 32).
template <int WORDS>
ED_FN void words_shl(uint32_t* u, int s) {
#pragma unroll
    for (int j = WORDS - 1; j > 0; j--) u[j] = (u[j] << s) | (u[j - 1] >> (32 - s));
    u[0] <<= s;
}

// The recoded scalar: u, Recoding::WORDS + 1 words, gets k plus the bias
// shifted up by SHIFT; returns the carry digit (0 or 1).
template <int NBYTES, int WBITS>
ED_FN int recode_start(uint32_t* u, const uint8_t* k) {
    using R = Recoding<NBYTES, WBITS>;
#pragma unroll
    for (int j = 0; j < R::WORDS; j++) {
        uint32_t w = 0;
#pragma unroll
        for (int b = 3; b >= 0; b--) w = (w << 8) | (4 * j + b < NBYTES ? k[4 * j + b] : 0u);
        u[j] = w;
    }
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < R::WORDS; j++) {
        const uint64_t s = (uint64_t)u[j] + recode_bias<R::BITS, WBITS>(j) + carry;
        u[j] = (uint32_t)s;
        carry = (uint32_t)(s >> 32);
    }
    u[R::WORDS] = carry;
    const int top = (int)((u[R::BITS >> 5] >> (R::BITS & 31)) & 1u);
    if constexpr (R::SHIFT > 0) words_shl<R::WORDS>(u, R::SHIFT);
    return top;
}

// The next digit, most significant first, in [-2^(W-1), 2^(W-1)).
template <int NBYTES, int WBITS>
ED_FN int recode_next(uint32_t* u) {
    using R = Recoding<NBYTES, WBITS>;
    const int d = (int)(u[R::WORDS - 1] >> (32 - WBITS)) - (1 << (WBITS - 1));
    words_shl<R::WORDS>(u, WBITS);
    return d;
}

template <int NBYTES, int WBITS, int STRIDE, int ESTRIDE = GC_WORDS>
ED_FN void window_acc(ge& acc, const ge& p, const uint8_t* k, int32_t* tab) {
    using R = Recoding<NBYTES, WBITS>;
    gc c;
    ge_cached(c, p);
    gc_store<STRIDE, ESTRIDE>(tab, 0, c);
    ge m = p;
#pragma unroll 1
    for (int e = 1; e < (1 << (WBITS - 1)); e++) {  // [e + 1]P = [e]P + P
        gc_load<STRIDE, ESTRIDE>(c, tab, 0);
        ge_add_cached(m, m, c);
        ge_cached(c, m);
        gc_store<STRIDE, ESTRIDE>(tab, e, c);
    }
    uint32_t u[R::WORDS + 1];
    const bool top = recode_start<NBYTES, WBITS>(u, k) != 0;
    ge_identity(acc);
    fe_select(acc.x, p.x, acc.x, top);
    fe_select(acc.y, p.y, acc.y, top);
    fe_select(acc.z, p.z, acc.z, top);
    fe_select(acc.t, p.t, acc.t, top);
#pragma unroll 1
    for (int w = 0; w < R::NWIN; w++) {
#pragma unroll
        for (int i = 1; i < WBITS; i++) ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, true);
        gc q;
        gc_lookup<STRIDE, ESTRIDE>(q, tab, recode_next<NBYTES, WBITS>(u));
        ge_add_cached(acc, acc, q);
    }
}

// A warp whose lanes all hold one point P (BASELINE config #3 puts each
// key on 64 consecutive lanes) needs one table, not 32: it runs the chain
// of least work, signed 4-bit windows, on the warp's one table of
// [1..8]P, entry e's word i at tab[41 e + i].  With entries 41 words
// apart a word of the 8 entries lies in 8 banks, and lanes with one
// digit read one word, so the reads are conflict-free too.  Every lane
// writes the same table with the same values and reads it after its own
// writes.
constexpr int WARP_WINDOW_BITS = 4;
constexpr int WARP_ENTRY_WORDS = GC_WORDS + 1;
constexpr int WARP_TABLE_WORDS = WARP_ENTRY_WORDS << (WARP_WINDOW_BITS - 1);

// [k]P for a lane: on its warp's one table (block_tab) when warp_point,
// else on its own column (block_tab + col, LANE_STRIDE words apart).
template <int NBYTES, int LANE_STRIDE>
ED_FN void window_acc_lane(ge& acc, const ge& p, const uint8_t* k, int32_t* block_tab, int col,
                           bool warp_point) {
    if (warp_point)
        window_acc<NBYTES, WARP_WINDOW_BITS, 1, WARP_ENTRY_WORDS>(acc, p, k, block_tab);
    else
        window_acc<NBYTES, WINDOW_BITS, LANE_STRIDE>(acc, p, k, block_tab + col);
}

#if defined(__CUDACC__)
// Whether every lane of this one-warp block below n holds the block's
// first lane's point encoding (128 bytes a lane); all 32 lanes call it,
// a lane past n comparing lane n - 1's.
__device__ __forceinline__ bool warp_one_point(const uint8_t* pts, int n) {
    const int first = blockIdx.x * blockDim.x;
    const int lane = min(first + (int)threadIdx.x, n - 1);
    const uint8_t* mine = pts + 128 * (size_t)lane;
    const uint8_t* lead = pts + 128 * (size_t)first;
    bool same = true;
#pragma unroll 8
    for (int i = 0; i < 128; i++) same &= mine[i] == lead[i];
    return __all_sync(0xffffffffu, same);
}
#endif
