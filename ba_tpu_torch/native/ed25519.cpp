// Native CPU Ed25519 (RFC 8032) + SHA-512 for the PyTorch port: batched
// commander signing and table verification for the signed SM(m) sweep
// (ba_tpu_torch/crypto/signed.py), without per-call Python overhead.
// The port's own copy of ba_tpu/native/ed25519.cpp, the same code;
// differentially tested against the pure-Python oracle
// (ba_tpu_torch/crypto/oracle.py) and against the reference's signer.
//
// Every magic constant (SHA-512 round constants, curve constants, base
// point, group order and its fold constants) is generated into
// constants.h by ba_tpu_torch/native/__init__.py FROM the Python oracle,
// so nothing here is hand-transcribed.
//
// Field arithmetic: GF(2^255-19) as 5 x 51-bit limbs in u64 with
// unsigned __int128 products (the classic "donna" radix). Scalar (mod L)
// arithmetic: base-256 limb folds (2^256 === -16*delta, then one exact
// 2^252 fold).  Points: extended twisted-Edwards (X:Y:Z:T) with the
// complete a=-1 addition law.
//
// NOT constant-time: this is a throughput/testing path for public data
// (commander signatures are public protocol messages), not a secret-key
// hygiene library.

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#include "constants.h"

typedef uint8_t u8;
typedef uint64_t u64;
typedef int64_t i64;
typedef unsigned __int128 u128;

// ---------------------------------------------------------------- SHA-512

typedef struct {
    u64 h[8];
    u8 buf[128];
    u64 len;  // total bytes
} sha512_ctx;

static inline u64 rotr64(u64 x, int n) { return (x >> n) | (x << (64 - n)); }

static void sha512_init(sha512_ctx* c) {
    for (int i = 0; i < 8; i++) c->h[i] = SHA512_H0[i];
    c->len = 0;
}

static void sha512_block(sha512_ctx* c, const u8* p) {
    u64 w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = 0;
        for (int j = 0; j < 8; j++) w[i] = (w[i] << 8) | p[i * 8 + j];
    }
    for (int i = 16; i < 80; i++) {
        u64 s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
        u64 s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u64 a = c->h[0], b = c->h[1], d = c->h[3], e = c->h[4];
    u64 cc = c->h[2], f = c->h[5], g = c->h[6], h = c->h[7];
    for (int i = 0; i < 80; i++) {
        u64 S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        u64 ch = (e & f) ^ (~e & g);
        u64 t1 = h + S1 + ch + SHA512_K[i] + w[i];
        u64 S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        u64 mj = (a & b) ^ (a & cc) ^ (b & cc);
        u64 t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += h;
}

static void sha512_update(sha512_ctx* c, const u8* p, size_t n) {
    size_t fill = (size_t)(c->len & 127);
    c->len += n;
    if (fill) {
        size_t take = 128 - fill;
        if (take > n) take = n;
        memcpy(c->buf + fill, p, take);
        p += take; n -= take; fill += take;
        if (fill < 128) return;
        sha512_block(c, c->buf);
    }
    while (n >= 128) { sha512_block(c, p); p += 128; n -= 128; }
    if (n) memcpy(c->buf, p, n);
}

static void sha512_final(sha512_ctx* c, u8 out[64]) {
    u64 bits_hi = c->len >> 61, bits_lo = c->len << 3;
    size_t fill = (size_t)(c->len & 127);
    u8 pad[256];
    memset(pad, 0, sizeof pad);
    pad[0] = 0x80;
    size_t padlen = ((fill < 112) ? 112 : 240) - fill;
    for (int i = 0; i < 8; i++) {
        pad[padlen + i] = (u8)(bits_hi >> (56 - 8 * i));
        pad[padlen + 8 + i] = (u8)(bits_lo >> (56 - 8 * i));
    }
    sha512_update(c, pad, padlen + 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (u8)(c->h[i] >> (56 - 8 * j));
}

static void sha512_3(u8 out[64], const u8* a, size_t an, const u8* b,
                     size_t bn, const u8* m, size_t mn) {
    sha512_ctx c;
    sha512_init(&c);
    if (an) sha512_update(&c, a, an);
    if (bn) sha512_update(&c, b, bn);
    if (mn) sha512_update(&c, m, mn);
    sha512_final(&c, out);
}

// ------------------------------------------------- GF(2^255-19), 5x51 bits

#define MASK51 ((1ULL << 51) - 1)

typedef struct { u64 v[5]; } fe;

static void fe_frombytes(fe* h, const u8 s[32]) {
    u64 w[4];
    for (int i = 0; i < 4; i++) {
        w[i] = 0;
        for (int j = 7; j >= 0; j--) w[i] = (w[i] << 8) | s[i * 8 + j];
    }
    h->v[0] = w[0] & MASK51;
    h->v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
    h->v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
    h->v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
    h->v[4] = (w[3] >> 12) & MASK51;  // top bit dropped (callers mask)
}

static void fe_carry(fe* h) {
    u64* v = h->v;
    for (int pass = 0; pass < 2; pass++) {
        for (int i = 0; i < 4; i++) {
            v[i + 1] += v[i] >> 51;
            v[i] &= MASK51;
        }
        u64 c = v[4] >> 51;
        v[4] &= MASK51;
        v[0] += 19 * c;
    }
}

// Canonical little-endian bytes; input limbs < 2^52.
static void fe_tobytes(u8 s[32], const fe* f) {
    fe t = *f;
    fe_carry(&t);
    // Conditionally subtract p (at most twice: value < 2p + eps).
    for (int rep = 0; rep < 2; rep++) {
        i64 b[5];
        b[0] = (i64)t.v[0] - (i64)(MASK51 - 18);  // p0 = 2^51 - 19
        for (int i = 1; i < 5; i++) b[i] = (i64)t.v[i] - (i64)MASK51;
        for (int i = 0; i < 4; i++) {
            i64 borrow = b[i] >> 51;  // arithmetic: 0 or -1
            b[i] -= borrow << 51;
            b[i + 1] += borrow;
        }
        if (b[4] >= 0) for (int i = 0; i < 5; i++) t.v[i] = (u64)b[i];
    }
    u64 w0 = t.v[0] | (t.v[1] << 51);
    u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
    u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
    u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
    u64 w[4] = {w0, w1, w2, w3};
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++) s[i * 8 + j] = (u8)(w[i] >> (8 * j));
}

static void fe_add(fe* h, const fe* f, const fe* g) {
    for (int i = 0; i < 5; i++) h->v[i] = f->v[i] + g->v[i];
}

// h = f - g, offset by 2p to stay nonnegative; limbs < 2^53.
static void fe_sub(fe* h, const fe* f, const fe* g) {
    h->v[0] = f->v[0] + 0xFFFFFFFFFFFDAULL - g->v[0];
    for (int i = 1; i < 5; i++)
        h->v[i] = f->v[i] + 0xFFFFFFFFFFFFEULL - g->v[i];
}

// Inputs: limbs < 2^54.  Output: carried, limbs < 2^52.
static void fe_mul(fe* h, const fe* f, const fe* g) {
    const u64 *a = f->v, *b = g->v;
    u64 b19_1 = 19 * b[1], b19_2 = 19 * b[2], b19_3 = 19 * b[3], b19_4 = 19 * b[4];
    u128 t0 = (u128)a[0] * b[0] + (u128)a[1] * b19_4 + (u128)a[2] * b19_3
            + (u128)a[3] * b19_2 + (u128)a[4] * b19_1;
    u128 t1 = (u128)a[0] * b[1] + (u128)a[1] * b[0] + (u128)a[2] * b19_4
            + (u128)a[3] * b19_3 + (u128)a[4] * b19_2;
    u128 t2 = (u128)a[0] * b[2] + (u128)a[1] * b[1] + (u128)a[2] * b[0]
            + (u128)a[3] * b19_4 + (u128)a[4] * b19_3;
    u128 t3 = (u128)a[0] * b[3] + (u128)a[1] * b[2] + (u128)a[2] * b[1]
            + (u128)a[3] * b[0] + (u128)a[4] * b19_4;
    u128 t4 = (u128)a[0] * b[4] + (u128)a[1] * b[3] + (u128)a[2] * b[2]
            + (u128)a[3] * b[1] + (u128)a[4] * b[0];
    u64 r0, r1, r2, r3, r4, c;
    r0 = (u64)t0 & MASK51; t1 += (u64)(t0 >> 51);
    r1 = (u64)t1 & MASK51; t2 += (u64)(t1 >> 51);
    r2 = (u64)t2 & MASK51; t3 += (u64)(t2 >> 51);
    r3 = (u64)t3 & MASK51; t4 += (u64)(t3 >> 51);
    r4 = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
    r0 += 19 * c; c = r0 >> 51; r0 &= MASK51; r1 += c;
    h->v[0] = r0; h->v[1] = r1; h->v[2] = r2; h->v[3] = r3; h->v[4] = r4;
}

static void fe_sq(fe* h, const fe* f) { fe_mul(h, f, f); }

static void fe_1(fe* h) { memset(h, 0, sizeof *h); h->v[0] = 1; }
static void fe_0(fe* h) { memset(h, 0, sizeof *h); }

// f ** e for a little-endian byte exponent (square-and-multiply, LSB-first).
static void fe_pow(fe* h, const fe* f, const u8* e, int nbytes) {
    fe result, base = *f;
    fe_1(&result);
    for (int i = 0; i < nbytes; i++) {
        for (int bit = 0; bit < 8; bit++) {
            if ((e[i] >> bit) & 1) fe_mul(&result, &result, &base);
            fe_sq(&base, &base);
        }
    }
    *h = result;
}

static void fe_inv(fe* h, const fe* f) { fe_pow(h, f, PM2_BYTES, 32); }

static int fe_eq(const fe* f, const fe* g) {
    u8 a[32], b[32];
    fe_tobytes(a, f);
    fe_tobytes(b, g);
    return memcmp(a, b, 32) == 0;
}

static int fe_iszero(const fe* f) {
    static const u8 zero[32] = {0};
    u8 a[32];
    fe_tobytes(a, f);
    return memcmp(a, zero, 32) == 0;
}

// --------------------------------------------- points (extended, a = -1)

typedef struct { fe x, y, z, t; } ge;

static fe FE_D, FE_D2, FE_SQRTM1, FE_BX, FE_BY;
static int CONSTS_READY = 0;

static void ge_identity(ge* p) {
    fe_0(&p->x); fe_1(&p->y); fe_1(&p->z); fe_0(&p->t);
}

static void ge_base(ge* p) {
    p->x = FE_BX; p->y = FE_BY; fe_1(&p->z);
    fe_mul(&p->t, &FE_BX, &FE_BY);
}

// Complete unified addition (add-2008-hwcd-3, a=-1) — the device formula.
static void ge_add(ge* r, const ge* p, const ge* q) {
    fe a, b, c, d, e, f, g, h, t1, t2;
    fe_sub(&t1, &p->y, &p->x);
    fe_sub(&t2, &q->y, &q->x);
    fe_mul(&a, &t1, &t2);
    fe_add(&t1, &p->y, &p->x);
    fe_add(&t2, &q->y, &q->x);
    fe_mul(&b, &t1, &t2);
    fe_mul(&c, &p->t, &q->t);
    fe_mul(&c, &c, &FE_D2);
    fe_mul(&d, &p->z, &q->z);
    fe_add(&d, &d, &d);
    fe_carry(&d);
    fe_sub(&e, &b, &a);
    fe_sub(&f, &d, &c);
    fe_add(&g, &d, &c);
    fe_add(&h, &b, &a);
    fe_mul(&r->x, &e, &f);
    fe_mul(&r->y, &g, &h);
    fe_mul(&r->z, &f, &g);
    fe_mul(&r->t, &e, &h);
}

// [k]P, k a little-endian byte scalar (double-and-add, LSB-first).
static void ge_scalarmult(ge* r, const ge* p, const u8* k, int nbytes) {
    ge acc, q = *p;
    ge_identity(&acc);
    for (int i = 0; i < nbytes; i++) {
        for (int bit = 0; bit < 8; bit++) {
            if ((k[i] >> bit) & 1) ge_add(&acc, &acc, &q);
            ge_add(&q, &q, &q);
        }
    }
    *r = acc;
}

// Fixed-base window table: T[w][j] = [j * 256^w]B — byte windows, twice
// the stride of the device path's 4-bit scheme (ba_tpu/crypto/
// ed25519.fixed_base_mult): [k]B is 32 complete additions and no
// doublings.  1.3 MB of table (32 x 256 x 160 B) and an 8k-addition
// one-time init (~the cost of ~130 signs) buy a 2x cut in the per-sign
// point arithmetic — the right trade for a batch signer that signs tens
// of thousands of times per process (the sweep's 2 signs/commander).
static ge BASE_TABLE[32][256];

static void base_table_init(void) {
    ge step;
    ge_base(&step);
    for (int w = 0; w < 32; w++) {
        ge_identity(&BASE_TABLE[w][0]);
        for (int j = 1; j < 256; j++)
            ge_add(&BASE_TABLE[w][j], &BASE_TABLE[w][j - 1], &step);
        ge_add(&step, &BASE_TABLE[w][255], &step);  // 256^(w+1) B
    }
}

// [k]B via the window table; k is 32 little-endian bytes.
static void ge_scalarmult_base(ge* r, const u8 k[32]) {
    ge acc;
    ge_identity(&acc);
    for (int i = 0; i < 32; i++)
        ge_add(&acc, &acc, &BASE_TABLE[i][k[i]]);
    *r = acc;
}

static void consts_init(void) {
    if (CONSTS_READY) return;
    fe_frombytes(&FE_D, D_BYTES);
    fe_frombytes(&FE_D2, D2_BYTES);
    fe_frombytes(&FE_SQRTM1, SQRTM1_BYTES);
    fe_frombytes(&FE_BX, BX_BYTES);
    fe_frombytes(&FE_BY, BY_BYTES);
    base_table_init();
    CONSTS_READY = 1;
}

static void ge_tobytes_with_zi(u8 s[32], const ge* p, const fe* zi) {
    fe x, y;
    fe_mul(&x, &p->x, zi);
    fe_mul(&y, &p->y, zi);
    fe_tobytes(s, &y);
    u8 xb[32];
    fe_tobytes(xb, &x);
    s[31] |= (xb[0] & 1) << 7;
}

static void ge_tobytes(u8 s[32], const ge* p) {
    fe zi;
    fe_inv(&zi, &p->z);
    ge_tobytes_with_zi(s, p, &zi);
}

// Batched point encoding with one shared inversion (Montgomery's trick):
// the per-point fe_inv (~254 squarings) is the dominant cost of encoding
// a fixed-base product on one core — prefix-product the Z's, invert the
// total once, and peel per-point inverses back out (3 muls + 1/chunk of
// an inversion per point).  Chunked so the working set stays in L1 and
// OpenMP can split batches when cores exist.
#define TOBYTES_CHUNK 256

static void ge_tobytes_batch(u8* out, size_t stride, const ge* pts,
                             size_t count) {
#pragma omp parallel for schedule(static)
    for (long c0 = 0; c0 < (long)count; c0 += TOBYTES_CHUNK) {
        size_t n = count - (size_t)c0;
        if (n > TOBYTES_CHUNK) n = TOBYTES_CHUNK;
        const ge* p = pts + c0;
        u8* o = out + stride * (size_t)c0;
        fe pre[TOBYTES_CHUNK];  // pre[i] = z_0 * ... * z_i
        pre[0] = p[0].z;
        for (size_t i = 1; i < n; i++) fe_mul(&pre[i], &pre[i - 1], &p[i].z);
        fe inv;
        fe_inv(&inv, &pre[n - 1]);  // 1/(z_0 ... z_{n-1})
        for (size_t i = n - 1; i > 0; i--) {
            fe zi;
            fe_mul(&zi, &inv, &pre[i - 1]);  // 1/z_i
            ge_tobytes_with_zi(o + stride * i, &p[i], &zi);
            fe_mul(&inv, &inv, &p[i].z);  // drop z_i from the pool
        }
        ge_tobytes_with_zi(o, &p[0], &inv);  // inv == 1/z_0
    }
}

// RFC 8032 5.1.3 decode; returns 0 on invalid encodings.
static int ge_frombytes(ge* p, const u8 s[32]) {
    // y < p (after masking the sign bit)?
    u8 yb[32];
    memcpy(yb, s, 32);
    int sign = yb[31] >> 7;
    yb[31] &= 0x7F;
    for (int i = 31; i >= 0; i--) {
        if (yb[i] < P_BYTES[i]) break;
        if (yb[i] > P_BYTES[i]) return 0;
        if (i == 0) return 0;  // y == p
    }
    fe y, yy, u, v, v3, v7, t, x, vxx, neg;
    fe_frombytes(&y, yb);
    fe one;
    fe_1(&one);
    fe_sq(&yy, &y);
    fe_sub(&u, &yy, &one);
    fe_carry(&u);  // u is a subtrahend below: keep limbs under the 2p offset
    fe_mul(&v, &yy, &FE_D);
    fe_add(&v, &v, &one);
    fe_carry(&v);
    fe_sq(&v3, &v);
    fe_mul(&v3, &v3, &v);
    fe_sq(&v7, &v3);
    fe_mul(&v7, &v7, &v);
    fe_mul(&t, &u, &v7);
    fe_pow(&t, &t, PM5D8_BYTES, 32);
    fe_mul(&x, &u, &v3);
    fe_mul(&x, &x, &t);
    fe_sq(&vxx, &x);
    fe_mul(&vxx, &vxx, &v);
    fe_0(&neg);
    fe_sub(&neg, &neg, &u);
    if (fe_eq(&vxx, &u)) {
        // x is the root
    } else if (fe_eq(&vxx, &neg)) {
        fe_mul(&x, &x, &FE_SQRTM1);
    } else {
        return 0;  // not a square: off-curve
    }
    u8 xb[32];
    fe_tobytes(xb, &x);
    if (fe_iszero(&x) && sign == 1) return 0;  // non-canonical x=0
    if ((xb[0] & 1) != sign) {
        fe_0(&neg);
        fe_sub(&x, &neg, &x);
        fe_carry(&x);
    }
    p->x = x; p->y = y; fe_1(&p->z);
    fe_mul(&p->t, &x, &y);
    return 1;
}

static int ge_eq(const ge* p, const ge* q) {
    fe a, b;
    fe_mul(&a, &p->x, &q->z);
    fe_mul(&b, &q->x, &p->z);
    if (!fe_eq(&a, &b)) return 0;
    fe_mul(&a, &p->y, &q->z);
    fe_mul(&b, &q->y, &p->z);
    return fe_eq(&a, &b);
}

// ------------------------------------------- scalars mod L (base-256 limbs)

// The reference's scalar fold plan, i64 limbs.
static void sc_fold256(i64* v, int n_in) {
    // v[0:n_in] -> v[0:16+(n_in-32)]: value === lo - hi * C16 (mod L).
    i64 hi[40];
    int nh = n_in - 32;
    for (int i = 0; i < nh; i++) hi[i] = v[32 + i];
    for (int i = 32; i < n_in; i++) v[i] = 0;  // all hi limbs consumed
    for (int j = 0; j < 17; j++) {
        i64 cj = (i64)C16_BYTES[j];
        if (!cj) continue;
        for (int i = 0; i < nh; i++) v[j + i] -= cj * hi[i];
    }
}

// One exact sequential pass: limbs 0..n-2 land in [0, 256); the final
// carry folds into v[n-1], which stays a small SIGNED limb (never
// dropped, so negative values survive the pass exactly).
static void sc_carry(i64* v, int n) {
    i64 c = 0;
    for (int i = 0; i < n - 1; i++) {
        i64 x = v[i] + c;
        c = x >> 8;
        v[i] = x - (c << 8);
    }
    v[n - 1] += c;
}

// in: 64 little-endian bytes -> out: 32 bytes, value mod L.
static void sc_reduce64(u8 out[32], const u8 in[64]) {
    i64 v[64];
    for (int i = 0; i < 64; i++) v[i] = in[i];
    sc_fold256(v, 64);   // touches 0..47; |value| < 2^385
    sc_carry(v, 49);     // limbs 0..47 in [0,256), v[48] small signed
    sc_fold256(v, 49);   // touches 0..32; |value| < 2^260
    sc_carry(v, 34);
    sc_fold256(v, 34);   // touches 0..17; |value| < 2^258 (lo < 2^257)
    // make nonnegative: + 4L > 2^135 covers the worst negative; value
    // lands in (0, 2^257 + 4L) < 2^259.
    for (int i = 0; i < 32; i++) v[i] += 4 * (i64)L_BYTES[i];
    sc_carry(v, 34);     // exact: limbs 0..32 in [0,256), v[33] == 0
    // exact fold at 2^252: value < 2^259 -> v[32] < 8, hi <= 143.
    i64 hi = (v[31] >> 4) + (v[32] << 4) + (v[33] << 12);
    v[31] &= 0xF;
    v[32] = v[33] = 0;
    for (int j = 0; j < 16; j++) v[j] -= hi * (i64)DELTA_BYTES[j];
    // + L once -> value in (0, 2^252 + L) subset (0, 2L); carry, then one
    // conditional subtract of L (second rep is a provable no-op kept for
    // symmetry with fe_tobytes).
    for (int i = 0; i < 32; i++) v[i] += (i64)L_BYTES[i];
    sc_carry(v, 33);
    for (int rep = 0; rep < 2; rep++) {
        i64 b[33], borrow = 0;
        for (int i = 0; i < 33; i++) {
            i64 li = i < 32 ? (i64)L_BYTES[i] : 0;
            i64 x = v[i] - li + borrow;
            borrow = x >> 8;
            b[i] = x - (borrow << 8);
        }
        if (borrow == 0)
            for (int i = 0; i < 33; i++) v[i] = b[i];
    }
    for (int i = 0; i < 32; i++) out[i] = (u8)v[i];
}

// out = (a * b + c) mod L  (a, b, c: 32 little-endian bytes, values < 2^255).
static void sc_muladd(u8 out[32], const u8 a[32], const u8 b[32], const u8 c[32]) {
    i64 v[64];
    for (int i = 0; i < 64; i++) v[i] = 0;
    for (int i = 0; i < 32; i++)
        for (int j = 0; j < 32; j++) v[i + j] += (i64)a[i] * (i64)b[j];
    for (int i = 0; i < 32; i++) v[i] += (i64)c[i];
    // exact sequential carry: value < 2^510 + 2^256 fits 64 limbs
    i64 carry = 0;
    u8 wide[64];
    for (int i = 0; i < 64; i++) {
        i64 x = v[i] + carry;
        carry = x >> 8;
        wide[i] = (u8)(x & 0xFF);
    }
    sc_reduce64(out, wide);
}

// s < L?  (little-endian byte compare)
static int sc_canonical(const u8 s[32]) {
    for (int i = 31; i >= 0; i--) {
        if (s[i] < L_BYTES[i]) return 1;
        if (s[i] > L_BYTES[i]) return 0;
    }
    return 0;  // s == L
}

// ------------------------------------------------------------- public API

extern "C" {

// One-time table/constant setup.  The Python loader calls this exactly
// once, under its own lock, right after dlopen — before any other entry
// point — so the in-library consts_init() calls below are belt-and-braces
// for direct C users, not the synchronization mechanism.
void ba_ed25519_init(void) { consts_init(); }

int ba_ed25519_publickey(const u8 sk[32], u8 pk[32]) {
    consts_init();
    u8 h[64];
    sha512_3(h, sk, 32, NULL, 0, NULL, 0);
    h[0] &= 248; h[31] &= 63; h[31] |= 64;
    ge A;
    ge_scalarmult_base(&A, h);
    ge_tobytes(pk, &A);
    return 1;
}

int ba_ed25519_sign(const u8 sk[32], const u8 pk[32], const u8* msg,
                    size_t msg_len, u8 sig[64]) {
    consts_init();
    u8 h[64], nonce[64], hram[64], r[32], k[32];
    sha512_3(h, sk, 32, NULL, 0, NULL, 0);
    u8 a[32];
    memcpy(a, h, 32);
    a[0] &= 248; a[31] &= 63; a[31] |= 64;
    sha512_3(nonce, h + 32, 32, msg, msg_len, NULL, 0);
    sc_reduce64(r, nonce);
    ge R;
    ge_scalarmult_base(&R, r);
    ge_tobytes(sig, &R);
    sha512_3(hram, sig, 32, pk, 32, msg, msg_len);
    sc_reduce64(k, hram);
    sc_muladd(sig + 32, k, a, r);
    return 1;
}

int ba_ed25519_verify(const u8 pk[32], const u8* msg, size_t msg_len,
                      const u8 sig[64]) {
    consts_init();
    if (!sc_canonical(sig + 32)) return 0;
    ge A, R;
    if (!ge_frombytes(&A, pk)) return 0;
    if (!ge_frombytes(&R, sig)) return 0;
    u8 hram[64], k[32];
    sha512_3(hram, sig, 32, pk, 32, msg, msg_len);
    sc_reduce64(k, hram);
    ge sB, hA, rhs;
    ge_scalarmult_base(&sB, sig + 32);
    ge_scalarmult(&hA, &A, k, 32);
    ge_add(&rhs, &R, &hA);
    return ge_eq(&sB, &rhs);
}

// Batch entry points are phased so every point encoding goes through the
// shared-inversion path (ge_tobytes_batch): compute all the fixed-base
// products first, then encode them together.  Per item that leaves
// 32 window additions + hashes + scalar arithmetic — the inversion that
// dominated the per-call path is amortized to ~nothing.

void ba_ed25519_publickey_batch(const u8* sks, size_t count, u8* pks) {
    consts_init();
    if (count == 0) return;
    ge* A = (ge*)malloc(count * sizeof(ge));
    if (!A) {  // degraded fallback: per-call path, no batch allocation
        for (size_t i = 0; i < count; i++)
            ba_ed25519_publickey(sks + 32 * i, pks + 32 * i);
        return;
    }
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)count; i++) {
        u8 h[64];
        sha512_3(h, sks + 32 * i, 32, NULL, 0, NULL, 0);
        h[0] &= 248; h[31] &= 63; h[31] |= 64;
        ge_scalarmult_base(&A[i], h);
    }
    ge_tobytes_batch(pks, 32, A, count);
    free(A);
}

void ba_ed25519_sign_batch(const u8* sks, const u8* pks, const u8* msgs,
                           size_t msg_len, size_t count, u8* sigs) {
    consts_init();
    if (count == 0) return;
    ge* R = (ge*)malloc(count * sizeof(ge));
    u8* ra = (u8*)malloc(count * 64);  // r scalar + clamped a per item
    if (!R || !ra) {
        free(R); free(ra);
        for (size_t i = 0; i < count; i++)
            ba_ed25519_sign(sks + 32 * i, pks + 32 * i, msgs + msg_len * i,
                            msg_len, sigs + 64 * i);
        return;
    }
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)count; i++) {
        u8 h[64], nonce[64];
        u8* r = ra + 64 * i;
        u8* a = ra + 64 * i + 32;
        sha512_3(h, sks + 32 * i, 32, NULL, 0, NULL, 0);
        memcpy(a, h, 32);
        a[0] &= 248; a[31] &= 63; a[31] |= 64;
        sha512_3(nonce, h + 32, 32, msgs + msg_len * i, msg_len, NULL, 0);
        sc_reduce64(r, nonce);
        ge_scalarmult_base(&R[i], r);
    }
    ge_tobytes_batch(sigs, 64, R, count);  // R bytes -> sig[0:32]
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)count; i++) {
        u8 hram[64], k[32];
        sha512_3(hram, sigs + 64 * i, 32, pks + 32 * i, 32,
                 msgs + msg_len * i, msg_len);
        sc_reduce64(k, hram);
        sc_muladd(sigs + 64 * i + 32, k, ra + 64 * i + 32, ra + 64 * i);
    }
    free(R);
    free(ra);
}

void ba_ed25519_verify_batch(const u8* pks, const u8* msgs, size_t msg_len,
                             size_t count, const u8* sigs, u8* oks) {
    consts_init();
#pragma omp parallel for schedule(static)
    for (long i = 0; i < (long)count; i++)
        oks[i] = (u8)ba_ed25519_verify(pks + 32 * i, msgs + msg_len * i,
                                       msg_len, sigs + 64 * i);
}

void ba_sha512(const u8* msg, size_t len, u8 out[64]) {
    sha512_3(out, msg, len, NULL, 0, NULL, 0);
}

}  // extern "C"
