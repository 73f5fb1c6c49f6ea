// GF(2^255 - 19) and Edwards-curve arithmetic shared by the Ed25519
// kernels K7 (decompress.cu), K4 (treeadd.cu), K3 (window_verify.cu) and
// K8 (powchain.cu), and the ED_FN / ED_CONST macros of K5, K5' and K6
// (sha512_modl.cu, modl.cu): the Hopper counterpart of
// ba_tpu/ops/planes.py and ba_tpu/ops/powchain.py.
//
// Radix.  The TPU reference keeps 22 signed 12-bit limbs in int32 because
// the TPU has no 64-bit integer unit.  Here a field element is ref10's
// 10 signed int32 limbs of alternately 26 and 25 bits (radix 2^25.5):
// limb i has weight 2^W[i], W = {0, 26, 51, 77, 102, 128, 153, 179, 204,
// 230}, and a product is 100 32x32 -> 64-bit multiplies (IMAD.WIDE)
// summed in int64 columns.  Since W[i] + W[j] - W[i+j] is 1 exactly when
// i and j are both odd, an odd-odd product counts twice; a column past
// limb 9 wraps to limb k - 10 times 19 (2^255 = 19 mod p).
//
// Lazy-reduction bounds (the int32 bounds of ba_tpu/crypto/field.py do
// not carry over).  Write u(f) = max_i |f_i| / 2^b_i, with b_i = 26 for
// even i and 25 for odd i.
// - fe_mul's output ("carried") has u <= 1/2 + 2^-8: limbs 1..9 in
//   [-2^(b-1), 2^(b-1)), limb 0 in [-2^25, 2^25), limb 1 off by < 2^16.
// - A canonical value (fe_frombytes, or the tables) has u < 1.
// - A lazy sum or difference adds the u of its terms.
// - fe_mul needs u(f) * u(g) <= 9.  Then each of the 10 terms of a column
//   is below u(f) u(g) 2^52 (odd limbs are half as wide, so the doubled
//   odd-odd product is no larger), a column below (1 + 9 * 19) u(f) u(g)
//   2^52 = 2^62.6 at the limit: inside int64, with the 19 applied to the
//   wrapped half of each column after it is summed.
// - fe_sq needs u(f) <= 3: the same columns, each pair of terms summed
//   as one product at twice the weight.
// - The point formulas below stay far inside: the largest operands are
//   sums of three carried values or two canonical ones (u <= 2), and the
//   largest product is 2 x 2 (p_point_add's (y1 - x1)(y2 - x2) on
//   canonical inputs).  fe_canonical and fe_tobytes take u <= 4.
//
// The functions compile as host C++ too (ED_FN is `static inline` without
// nvcc), so the per-lane arithmetic can be checked off the card.

#pragma once
#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define ED_FN __device__ __forceinline__
#define ED_CONST __device__ __constant__ const
#else
#define ED_FN static inline
#define ED_CONST static const
#endif

struct fe {
    int32_t v[10];
};

struct ge {  // extended twisted-Edwards point (X : Y : Z : T), a = -1
    fe x, y, z, t;
};

// Limb weights and widths.
#define FE_W(i) (((i) * 51 + 1) / 2)  // ceil(25.5 i)
#define FE_B(i) (((i) & 1) ? 25 : 26)

// Curve constants in this radix (ref10's d.h, d2.h and sqrtm1.h); each is
// held against the oracle's value by tests/test_torch_ed25519.py.
ED_CONST int32_t FE_D_LIMBS[10] = {
    -10913610, 13857413, -15372611, 6949391, 114729,
    -8787816, -6275908, -3247719, -18696448, -12055116};
ED_CONST int32_t FE_D2_LIMBS[10] = {
    -21827239, -5839606, -30745221, 13898782, 229458,
    15978800, -12551817, -6495438, 29715968, 9444199};
ED_CONST int32_t FE_SQRTM1_LIMBS[10] = {
    -32595792, -7943725, 9377950, 3500415, 12389472,
    -272473, -25146209, -2005654, 326686, 11406482};

ED_FN void fe_load(fe& h, const int32_t* c) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

ED_FN void fe_0(fe& h) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = 0;
}

ED_FN void fe_1(fe& h) {
    fe_0(h);
    h.v[0] = 1;
}

ED_FN void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
}

ED_FN void fe_sub(fe& h, const fe& f, const fe& g) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
}

ED_FN void fe_neg(fe& h, const fe& f) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = -f.v[i];
}

// Rounding carries of int64 columns into a carried fe: one sequential
// chain 0 -> 9, limb 9's carry back into limb 0 times 19, and one more
// carry out of limb 0.
ED_FN void fe_reduce64(fe& h, int64_t t[10]) {
#pragma unroll
    for (int k = 0; k < 10; k++) {
        const int b = FE_B(k);
        int64_t c = (t[k] + ((int64_t)1 << (b - 1))) >> b;
        t[k] -= c * ((int64_t)1 << b);
        if (k < 9)
            t[k + 1] += c;
        else
            t[0] += 19 * c;
    }
    int64_t c = (t[0] + ((int64_t)1 << 25)) >> 26;
    t[0] -= c * ((int64_t)1 << 26);
    t[1] += c;
#pragma unroll
    for (int k = 0; k < 10; k++) h.v[k] = (int32_t)t[k];
}

// h = f * g; needs u(f) * u(g) <= 9 (header comment); h carried.
ED_FN void fe_mul(fe& h, const fe& f, const fe& g) {
    int32_t f2[10];
#pragma unroll
    for (int i = 0; i < 10; i++) f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    int64_t lo[10], hi[9];
#pragma unroll
    for (int k = 0; k < 10; k++) lo[k] = 0;
#pragma unroll
    for (int k = 0; k < 9; k++) hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            int64_t p = (int64_t)((i & j & 1) ? f2[i] : f.v[i]) * (int64_t)g.v[j];
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
    int64_t t[10];
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = lo[k] + 19 * hi[k];
    t[9] = lo[9];
    fe_reduce64(h, t);
}

// h = f^2; needs u(f) <= 3 (as fe_mul with g = f); h carried.  55
// products: each f_i f_j with i < j once, at twice its weight (four
// times for odd i and j), and the 10 squares (twice for odd i).  The
// premultiplied limbs stay in int32: |4 f_i| < 12 * 2^25 for odd i.
ED_FN void fe_sq(fe& h, const fe& f) {
    int32_t f2[10], f4[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        f2[i] = 2 * f.v[i];
        f4[i] = 2 * f2[i];
    }
    int64_t lo[10], hi[9];
#pragma unroll
    for (int k = 0; k < 10; k++) lo[k] = 0;
#pragma unroll
    for (int k = 0; k < 9; k++) hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            const bool odd = (i & j & 1) != 0;
            const int32_t a = (i == j) ? (odd ? f2[i] : f.v[i]) : (odd ? f4[i] : f2[i]);
            const int64_t p = (int64_t)a * (int64_t)f.v[j];
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
    int64_t t[10];
#pragma unroll
    for (int k = 0; k < 9; k++) t[k] = lo[k] + 19 * hi[k];
    t[9] = lo[9];
    fe_reduce64(h, t);
}

// h = f * 2 as a lazy value (u doubles).
ED_FN void fe_dbl(fe& h, const fe& f) { fe_add(h, f, f); }

// Exact limbs of the canonical value of f (u(f) <= 4): t[i] in
// [0, 2^b_i), value in [0, p).
ED_FN void fe_canonical(int64_t t[10], const fe& f) {
    // + 8p limb by limb (8 (2^26 - 19), 8 (2^25 - 1), 8 (2^26 - 1), ...)
    // makes every limb positive, since |f_i| < 4 * 2^b_i.
#pragma unroll
    for (int i = 0; i < 10; i++)
        t[i] = (int64_t)f.v[i] + 8 * (((int64_t)1 << FE_B(i)) - (i == 0 ? 19 : 1));
    // Three exact chains (floor carries of non-negative limbs), limb 9's
    // carry folding back times 19: the value lands in [0, 2^255).
#pragma unroll
    for (int rep = 0; rep < 3; rep++) {
#pragma unroll
        for (int k = 0; k < 10; k++) {
            const int b = FE_B(k);
            int64_t c = t[k] >> b;
            t[k] -= c << b;
            if (k < 9)
                t[k + 1] += c;
            else
                t[0] += 19 * c;
        }
    }
    // Subtract p once if value >= p, i.e. if value + 19 >= 2^255.
    int64_t q = (t[0] + 19) >> 26;
#pragma unroll
    for (int k = 1; k < 10; k++) q = (t[k] + q) >> FE_B(k);
    t[0] += 19 * q;
#pragma unroll
    for (int k = 0; k < 9; k++) {
        const int b = FE_B(k);
        int64_t c = t[k] >> b;
        t[k] -= c << b;
        t[k + 1] += c;
    }
    t[9] &= ((int64_t)1 << 25) - 1;  // drops the 2^255 that q added
}

// Canonical little-endian encoding.
ED_FN void fe_tobytes(uint8_t s[32], const fe& f) {
    int64_t t[10];
    fe_canonical(t, f);
    uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int off = FE_W(i), idx = off >> 6, sh = off & 63;
        w[idx] |= (uint64_t)t[i] << sh;
        if (sh + FE_B(i) > 64) w[idx + 1] |= (uint64_t)t[i] >> (64 - sh);
    }
#pragma unroll
    for (int i = 0; i < 32; i++) s[i] = (uint8_t)(w[i >> 3] >> (8 * (i & 7)));
}

// The low 255 bits of a little-endian encoding (bit 255 is dropped).
ED_FN void fe_frombytes(fe& h, const uint8_t s[32]) {
    uint64_t w[4];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        uint64_t x = 0;
#pragma unroll
        for (int j = 7; j >= 0; j--) x = (x << 8) | s[8 * k + j];
        w[k] = x;
    }
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int off = FE_W(i), idx = off >> 6, sh = off & 63;
        uint64_t x = w[idx] >> sh;
        if (sh + FE_B(i) > 64) x |= w[idx + 1] << (64 - sh);
        h.v[i] = (int32_t)(x & ((1ULL << FE_B(i)) - 1));
    }
}

ED_FN bool fe_eq(const fe& f, const fe& g) {
    int64_t a[10], b[10];
    fe_canonical(a, f);
    fe_canonical(b, g);
    bool same = true;
#pragma unroll
    for (int i = 0; i < 10; i++) same = same && (a[i] == b[i]);
    return same;
}

ED_FN void fe_select(fe& h, const fe& f, const fe& g, bool take_f) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = take_f ? f.v[i] : g.v[i];
}

ED_FN void fe_sq_n(fe& h, const fe& f, int n) {
    h = f;
#pragma unroll 1
    for (int i = 0; i < n; i++) fe_sq(h, h);
}

// The 2^k - 1 tower (ba_tpu/ops/powchain.py:48): z^(2^250 - 1).
ED_FN void fe_tower_250(fe& out, const fe& z) {
    fe t2, t4, t5, t10, t20, t40, t50, t100, s;
    fe_sq_n(s, z, 1);     fe_mul(t2, s, z);
    fe_sq_n(s, t2, 2);    fe_mul(t4, s, t2);
    fe_sq_n(s, t4, 1);    fe_mul(t5, s, z);
    fe_sq_n(s, t5, 5);    fe_mul(t10, s, t5);
    fe_sq_n(s, t10, 10);  fe_mul(t20, s, t10);
    fe_sq_n(s, t20, 20);  fe_mul(t40, s, t20);
    fe_sq_n(s, t40, 10);  fe_mul(t50, s, t10);
    fe_sq_n(s, t50, 50);  fe_mul(t100, s, t50);
    fe_sq_n(s, t100, 100); fe_mul(s, s, t100);  // t200
    fe_sq_n(s, s, 50);    fe_mul(out, s, t50);
}

// z^((p-5)/8) = z^(2^252 - 3) = t_250^4 * z (ba_tpu/ops/powchain.py:68).
ED_FN void fe_sqrt_chain(fe& out, const fe& z) {
    fe t;
    fe_tower_250(t, z);
    fe_sq_n(t, t, 2);
    fe_mul(out, t, z);
}

// z^(p-2) = 1/z = t_250^32 * z^11 (ba_tpu/ops/powchain.py:74): 257
// squarings and 13 multiplies; z = 0 gives 0.
ED_FN void fe_inv_chain(fe& out, const fe& z) {
    fe z2, z11, t;
    fe_sq(z2, z);
    fe_sq_n(t, z2, 2);
    fe_mul(t, t, z);     // z^9
    fe_mul(z11, t, z2);  // z^11
    fe_tower_250(t, z);
    fe_sq_n(t, t, 5);
    fe_mul(out, t, z11);
}

// -- points ------------------------------------------------------------------

ED_FN void ge_identity(ge& p) {
    fe_0(p.x);
    fe_1(p.y);
    fe_1(p.z);
    fe_0(p.t);
}

// Complete unified addition, add-2008-hwcd-3 with a = -1: 9 multiplies
// (ba_tpu/ops/planes.py:167, the same formula term for term).  With
// z_one the caller promises Z = 1 in both points (affine table entries):
// Z1 Z2 is then 1 and is not multiplied, 8 multiplies.
ED_FN void ge_add(ge& r, const ge& p, const ge& q, bool z_one = false) {
    fe a, b, c, d, e, f, g, h, s1, s2, d2;
    fe_sub(s1, p.y, p.x);
    fe_sub(s2, q.y, q.x);
    fe_mul(a, s1, s2);
    fe_add(s1, p.y, p.x);
    fe_add(s2, q.y, q.x);
    fe_mul(b, s1, s2);
    fe_mul(c, p.t, q.t);
    fe_load(d2, FE_D2_LIMBS);
    fe_mul(c, c, d2);
    if (z_one)
        fe_1(d);
    else
        fe_mul(d, p.z, q.z);
    fe_dbl(d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    fe_mul(r.t, e, h);
}

// Dedicated doubling, dbl-2008-hwcd with a = -1 (ba_tpu/ops/planes.py:182):
// A = X^2, B = Y^2, C = 2 Z^2, E = 2 X Y, G = B - A, F = G - C,
// H = -(A + B); out (E F, G H, F G, E H).  7 multiplies, 8 with T; the
// input T is never read, and with_t = false leaves T zero.
ED_FN void ge_dbl(ge& r, const ge& p, bool with_t) {
    fe a, b, c, e, f, g, h;
    fe_sq(a, p.x);
    fe_sq(b, p.y);
    fe_sq(c, p.z);
    fe_dbl(c, c);
    fe_mul(e, p.x, p.y);
    fe_dbl(e, e);
    fe_sub(g, b, a);
    fe_sub(f, g, c);
    fe_add(h, a, b);
    fe_neg(h, h);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    if (with_t)
        fe_mul(r.t, e, h);
    else
        fe_0(r.t);
}

// A point as four canonical 32-byte encodings (X, Y, Z, T): the kernels'
// interface layout, uint8 [N, 4, 32].
ED_FN void ge_frombytes4(ge& p, const uint8_t* s) {
    fe_frombytes(p.x, s);
    fe_frombytes(p.y, s + 32);
    fe_frombytes(p.z, s + 64);
    fe_frombytes(p.t, s + 96);
}

ED_FN void ge_tobytes4(uint8_t* s, const ge& p) {
    fe_tobytes(s, p.x);
    fe_tobytes(s + 32, p.y);
    fe_tobytes(s + 64, p.z);
    fe_tobytes(s + 96, p.t);
}
