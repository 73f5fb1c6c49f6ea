// The reduction of a 512-bit little-endian value mod L, the Ed25519 group
// order, shared by K5 (sha512_modl.cu, after the hash) and K6 (modl.cu,
// alone): the function of ba_tpu/ops/modl.py::modl_core, in 32-bit words.
//
//     L = 2^252 + delta,  delta < 2^125 (4 words)
//
// The TPU kernel keeps 64 byte limbs because there each limb is a vector
// register and a byte constant a free immediate; on a scalar thread that
// layout took 2 331 integer instructions a lane, 64 of them byte loads
// that each touch a sector a thread.  Here the 64 bytes are
// sixteen 32-bit words as loaded (little endian), and the reduction is
// Barrett's, with 32 x 32 -> 64-bit products (IMAD.WIDE.U32) summed in
// uint64_t, ~50 products in all:
// - q = floor(x / 2^252) (9 words by funnel shifts).  With mu =
//   floor(2^512 / L) = 2^260 - M, M < 2^133 (5 words), Barrett's quotient
//   floor(q mu / 2^260) = q - ceil(q M / 2^260) is at most 2 below
//   floor(x / L).  Only the products q_i M_j with i + j >= 7 are summed
//   (20 of 45): the rest sum below 0.44 * 2^260, so with v that partial
//   product over 2^260, qh = q - floor(v) - 2 is never above floor(x / L)
//   and at most 3 below it.
// - r = x - qh L mod 2^256 (26 word products of qh delta; 2^252 qh is a
//   shift): the true value is in [0, 4L), so the low 256 bits are exact.
// - The exact fold at 2^252 (2^252 = -delta mod L): t = r >> 252 <= 3,
//   r mod 2^252 - t delta > -L, then L added once where that is negative.
// The TPU's fold plan on words (folds at 2^252 by delta, a multiple of L
// added to keep each non-negative: 36 + 20 + 4 products) is the other
// candidate: scripts/k6k5_variants/ counts both in SASS (a lane with its
// loads and stores: 267 instructions here, 325 there) and times both.
//
// Plain C only (no inline PTX): tests/torch_csrc_host.cpp compiles this
// header with g++.

#pragma once
#include "ed25519_field.cuh"

// delta = L - 2^252 and M = 2^260 - floor(2^512 / L) as little-endian
// 32-bit words; held against the oracle's L by tests/test_torch_sha512.py.
ED_CONST uint32_t MODL_DELTA[4] = {0x5cf5d3ed, 0x5812631a, 0xa2f79cd6, 0x14def9de};
ED_CONST uint32_t MODL_M[5] = {0xf5d3ece5, 0x12631a5c, 0xf79cd658, 0xdef9dea2, 0x14};

// 16 bytes, four little-endian words: one vector load or store on the card.
#if defined(__CUDACC__)
typedef uint4 modl_vec;
#else
struct modl_vec {
    uint32_t x, y, z, w;
};
#endif

// The exact fold at 2^252: r (8 words, below 2^252) -> (r - t delta) mod
// L, for t with r - t delta > -L: subtract t delta, then add L where the
// difference is negative.
ED_FN void modl_finish(uint32_t r[8], int64_t t) {
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const int64_t s = (int64_t)r[i] - (i < 4 ? t * MODL_DELTA[i] : 0) + c;
        r[i] = (uint32_t)s;
        c = s >> 32;
    }
    const uint32_t neg = (uint32_t)c;  // all ones when the value went negative
    uint64_t a = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint32_t l = i < 4 ? MODL_DELTA[i] : (i == 7 ? 0x10000000u : 0u);
        a += (uint64_t)r[i] + (l & neg);
        r[i] = (uint32_t)a;
        a >>= 32;
    }
}

// x (16 little-endian words, < 2^512) -> x mod L (8 words).
ED_FN void modl_words(const uint32_t w[16], uint32_t r[8]) {
    uint32_t q[9];  // floor(x / 2^252)
#pragma unroll
    for (int i = 0; i < 8; i++) q[i] = (w[7 + i] >> 28) | (w[8 + i] << 4);
    q[8] = w[15] >> 28;
    // v[k]: word 7 + k of the sum of q_i M_j 2^(32 (i + j)) over i + j >= 7,
    // row by row (row i's carry lands in column i + 5, not yet written).
    uint32_t v[7];
#pragma unroll
    for (int k = 0; k < 7; k++) v[k] = 0;
#pragma unroll
    for (int i = 3; i < 9; i++) {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; j < 5; j++) {
            if (i + j < 7) continue;
            const uint64_t t = (uint64_t)q[i] * MODL_M[j] + v[i + j - 7] + carry;
            v[i + j - 7] = (uint32_t)t;
            carry = (uint32_t)(t >> 32);
        }
        v[i - 2] = carry;
    }
    // qh = q - floor(v / 2^36) - 2 mod 2^256 (v's word 0 has weight 2^224)
    uint32_t qh[8];
    int64_t c = -2;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int64_t fv = k < 5 ? (int64_t)((v[1 + k] >> 4) | (v[2 + k] << 28)) : 0;
        const int64_t s = (int64_t)q[k] - fv + c;
        qh[k] = (uint32_t)s;
        c = s >> 32;
    }
    // p = qh delta mod 2^256
    uint32_t p[8];
#pragma unroll
    for (int k = 0; k < 8; k++) p[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            if (i + j > 7) continue;
            const uint64_t t = (uint64_t)qh[i] * MODL_DELTA[j] + p[i + j] + carry;
            p[i + j] = (uint32_t)t;
            carry = (uint32_t)(t >> 32);
        }
        if (i + 4 <= 7) p[i + 4] = carry;
    }
    // r = x - p - 2^252 qh mod 2^256, in [0, 4L)
    c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int64_t s = (int64_t)w[k] - p[k] - (k == 7 ? (int64_t)(qh[0] << 28) : 0) + c;
        r[k] = (uint32_t)s;
        c = s >> 32;
    }
    const int64_t t = r[7] >> 28;
    r[7] &= 0x0fffffff;
    modl_finish(r, t);
}

// Four 16-byte vectors in (x) -> two out (x mod L).
ED_FN void modl_vecs(const modl_vec x[4], modl_vec out[2]) {
    const uint32_t w[16] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y, x[1].z, x[1].w,
                            x[2].x, x[2].y, x[2].z, x[2].w, x[3].x, x[3].y, x[3].z, x[3].w};
    uint32_t r[8];
    modl_words(w, r);
    out[0] = modl_vec{r[0], r[1], r[2], r[3]};
    out[1] = modl_vec{r[4], r[5], r[6], r[7]};
}
