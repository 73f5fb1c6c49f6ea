// 1/z in GF(2^255 - 19) by Bernstein and Yang's constant-time divsteps
// ("Fast constant-time gcd computation and modular inversion", 2019), in
// the half-delta form and the 30-bit batches of libsecp256k1's modinv32:
// K8's inversion (powchain.cu compress_lane).
//
// Why not the 2^k - 1 chain (fe_inv_chain): its 257 squarings and 15
// multiplies are one dependent chain of ~49 k integer instructions, so one
// lane waits on latency at every step, and a few warps a SM cannot hide it.
// Here a lane runs 20 batches; each batch makes 30 branch-free divsteps on
// the low words of (f, g) alone (32-bit masks, ~27 instructions a step),
// giving a 2x2 matrix t of entries |t| <= 2^30, then applies t / 2^30 to
// (f, g) and to (d, e) in 9 signed 30-bit limbs (int64 products, the limbs
// independent but for one carry chain).  ~21 k instructions a lane,
// 30-step chains of ~7 dependent instructions between the products.
//
// Invariants (f, g start at (p, z), d, e at (0, 1)): d z = f and e z = g
// (mod p); each divstep keeps gcd(f, g) up to a power of two, and after
// enough of them g = 0 and f = +-gcd = +-1 for z != 0, so 1/z = +-d.
// - Step count: 600 = 20 x 30 divsteps, above the 590 that suffice for
//   inputs below 2^256 in the half-delta form (libsecp256k1's bound, as in
//   its modinv32); z < p < 2^255 here.  Extra divsteps after g = 0 only
//   halve e, so any count above the bound gives the same d.
// - Ranges: f, g stay within (-p, p], d, e within (-2p, p) (libsecp256k1's
//   update_de, which adds u, q for a negative d and v, r for a negative e
//   before choosing the multiple of p that clears the low 30 bits); every
//   limb product and sum fits int64 (|t| <= 2^30, limbs < 2^30, the
//   multiple of p's factor |md| < 2^31).
// - z is reduced mod p first (fe_canonical: z = p gives 0), so z = 0 mod p
//   leaves g = 0 from the start, f = p and d = 0: 1/0 = 0, as the chain.
// - The result is normalised into [0, p) (d + p where d < 0, negated
//   where f = -1, + p again where still negative) and returned as a
//   carried fe whose canonical value is that residue.
//
// The functions compile as host C++ too (ED_FN), so the CPU tests replay
// the inversion off the card.

#pragma once
#include "ed25519_field.cuh"

struct s30 {  // value = sum v[i] 2^(30 i); v[0..7] in [0, 2^30), v[8] signed
    int32_t v[9];
};

#define BY_M30 0x3FFFFFFF
#define BY_BATCHES 20
#define BY_STEPS 30
#define BY_P_INV30 0x179435E5u  // p^-1 mod 2^30

// p = 2^255 - 19 in 30-bit limbs: 2^30 - 19, seven 2^30 - 1, 2^15 - 1.
ED_FN int32_t by_p_limb(int i) { return i == 0 ? 0x3FFFFFED : (i == 8 ? 0x7FFF : BY_M30); }

// 30 divsteps on the low words of (f, g): zeta = -(delta + 1/2), and the
// matrix (u v; q r) with (f', g') 2^30 = t (f, g).
struct ByMatrix {
    int32_t u, v, q, r;
};

ED_FN int32_t by_divsteps_30(int32_t zeta, uint32_t f, uint32_t g, ByMatrix& t) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int i = 0; i < BY_STEPS; i++) {
        uint32_t m1 = (uint32_t)(zeta >> 31);  // delta > 0
        const uint32_t m2 = 0u - (g & 1u);      // g odd
        const uint32_t x = (f ^ m1) - m1, y = (u ^ m1) - m1, z = (v ^ m1) - m1;
        g += x & m2;
        q += y & m2;
        r += z & m2;
        m1 &= m2;  // swap: delta > 0 and g odd
        zeta = (int32_t)(((uint32_t)zeta ^ m1) - 1u);
        f += g & m1;
        u += q & m1;
        v += r & m1;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t.u = (int32_t)u;
    t.v = (int32_t)v;
    t.q = (int32_t)q;
    t.r = (int32_t)r;
    return zeta;
}

// (f, g) <- t (f, g) / 2^30, exact.
ED_FN void by_update_fg(s30& f, s30& g, const ByMatrix& t) {
    int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
    int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; i++) {
        cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
        cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
        f.v[i - 1] = (int32_t)cf & BY_M30;
        g.v[i - 1] = (int32_t)cg & BY_M30;
        cf >>= 30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me chosen so the low 30
// bits vanish: t (d, e) / 2^30 mod p, kept in (-2p, p).
ED_FN void by_update_de(s30& d, s30& e, const ByMatrix& t) {
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (t.u & sd) + (t.v & se);
    int32_t me = (t.q & sd) + (t.r & se);
    int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
    int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
    md -= (int32_t)((BY_P_INV30 * (uint32_t)cd + (uint32_t)md) & BY_M30);
    me -= (int32_t)((BY_P_INV30 * (uint32_t)ce + (uint32_t)me) & BY_M30);
    cd += (int64_t)by_p_limb(0) * md;
    ce += (int64_t)by_p_limb(0) * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; i++) {
        cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] + (int64_t)by_p_limb(i) * md;
        ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] + (int64_t)by_p_limb(i) * me;
        d.v[i - 1] = (int32_t)cd & BY_M30;
        e.v[i - 1] = (int32_t)ce & BY_M30;
        cd >>= 30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// d + (p where add), then the carries (v[0..7] back into [0, 2^30)).
ED_FN void by_add_p_carry(s30& d, int32_t add) {
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        c += (int64_t)d.v[i] + (by_p_limb(i) & add);
        if (i < 8) {
            d.v[i] = (int32_t)c & BY_M30;
            c >>= 30;
        } else {
            d.v[8] = (int32_t)c;
        }
    }
}

// d in (-2p, p) and f = +-1 -> d f mod p in [0, p).
ED_FN void by_normalize(s30& d, int32_t f_sign) {
    by_add_p_carry(d, d.v[8] >> 31);  // (-p, p)
#pragma unroll
    for (int i = 0; i < 9; i++) d.v[i] = (d.v[i] ^ f_sign) - f_sign;
    by_add_p_carry(d, 0);  // the negated limbs carried
    by_add_p_carry(d, d.v[8] >> 31);  // [0, p)
}

// Canonical fe -> s30 and s30 in [0, p) -> fe, through four 64-bit words.
ED_FN void by_from_fe(s30& r, const fe& z) {
    int64_t t[10];
    fe_canonical(t, z);
    uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int off = FE_W(i), idx = off >> 6, sh = off & 63;
        w[idx] |= (uint64_t)t[i] << sh;
        if (sh + FE_B(i) > 64) w[idx + 1] |= (uint64_t)t[i] >> (64 - sh);
    }
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int off = 30 * i, idx = off >> 6, sh = off & 63;
        uint64_t x = w[idx] >> sh;
        if (sh + 30 > 64 && idx < 3) x |= w[idx + 1] << (64 - sh);  // limb 8 ends at bit 255
        r.v[i] = (int32_t)(x & BY_M30);
    }
}

ED_FN void by_to_fe(fe& h, const s30& d) {
    uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int off = 30 * i, idx = off >> 6, sh = off & 63;
        w[idx] |= (uint64_t)(uint32_t)d.v[i] << sh;
        if (sh + 30 > 64 && idx < 3) w[idx + 1] |= (uint64_t)(uint32_t)d.v[i] >> (64 - sh);
    }
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int off = FE_W(i), idx = off >> 6, sh = off & 63;
        uint64_t x = w[idx] >> sh;
        if (sh + FE_B(i) > 64) x |= w[idx + 1] << (64 - sh);
        h.v[i] = (int32_t)(x & ((1ULL << FE_B(i)) - 1));
    }
}

// out = 1/z (0 for z = 0 mod p); z any carried fe (u <= 4).
ED_FN void fe_inv_safegcd(fe& out, const fe& z) {
    s30 f, g, d, e;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        f.v[i] = by_p_limb(i);
        d.v[i] = 0;
        e.v[i] = 0;
    }
    e.v[0] = 1;
    by_from_fe(g, z);
    int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
    for (int b = 0; b < BY_BATCHES; b++) {
        ByMatrix t;
        zeta = by_divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
        by_update_fg(f, g, t);
        by_update_de(d, e, t);
    }
    by_normalize(d, f.v[8] >> 31);  // f = +-1: its sign is its top limb's
    by_to_fe(out, d);
}
