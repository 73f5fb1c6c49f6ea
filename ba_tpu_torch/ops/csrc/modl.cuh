// The reduction of a 512-bit little-endian value mod L, the Ed25519 group
// order, shared by K5 (sha512_modl.cu, after the hash) and K6 (modl.cu,
// alone): the device function of ba_tpu/ops/modl.py::modl_core.
//
//     L = 2^252 + delta,  delta < 2^125,  so  2^256 = -16 delta  (mod L)
//
// Three folds at the 2^256 limb boundary, an exact fold at 2^252 and one
// conditional subtract of L, on base-256 limbs in int64 where the
// reference keeps int32 (no value changes).  ~900 multiply-adds a lane.

#pragma once
#include "ed25519_field.cuh"

// L in little-endian bytes (its low 16 bytes are delta) and C16 = 16 delta
// (2^256 = -C16 mod L); held against the oracle's L by
// tests/test_torch_sha512.py.
ED_CONST int32_t MODL_L[32] = {
    237, 211, 245, 92, 26, 99, 18, 88, 214, 156, 247, 162, 222, 249, 222, 20,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 16};
ED_CONST int32_t MODL_C16[17] = {
    208, 62, 93, 207, 165, 49, 38, 129, 101, 205, 121, 47, 234, 157, 239, 77, 1};

// One exact sequential base-256 pass over v[0..n); the signed final
// carry lands in v[n-1] (ba_tpu/ops/modl.py::_carry_seq).
ED_FN void modl_carry_seq(int64_t* v, int n) {
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < n - 1; i++) {
        const int64_t x = v[i] + c;
        c = x >> 8;
        v[i] = x - c * 256;
    }
    v[n - 1] += c;
}

// v[0..n_in) -> v[0..n_out): value = lo - hi * C16 (mod L), hi = v[32..),
// n_out = max(32, 16 + n_in - 32); limbs 32.. of the input are consumed.
ED_FN void modl_fold256(int64_t* v, int n_in) {
    int64_t hi[32];
    const int nh = n_in - 32;
#pragma unroll
    for (int i = 0; i < 32; i++) hi[i] = i < nh ? v[32 + i] : 0;
#pragma unroll
    for (int i = 32; i < 64; i++) v[i] = 0;
#pragma unroll
    for (int j = 0; j < 17; j++)
#pragma unroll
        for (int i = 0; i < 32; i++)
            if (i < nh) v[j + i] -= MODL_C16[j] * hi[i];
}

// modl_core (ba_tpu/ops/modl.py:69): 64 bytes as limbs -> 32 bytes mod L.
ED_FN void modl_core(int64_t v[64], uint8_t out[32]) {
    modl_fold256(v, 64);   // 48 limbs
    modl_carry_seq(v, 49); // |value| < 2^385
    modl_fold256(v, 49);   // 33 limbs
    modl_carry_seq(v, 34); // |value| < 2^260
    modl_fold256(v, 34);   // 32 limbs; |value| < 2^258
    v[32] = 0;
    v[33] = 0;
#pragma unroll
    for (int i = 0; i < 32; i++) v[i] += 4 * MODL_L[i];
    modl_carry_seq(v, 34); // value in (0, 2^259)
    // Exact fold at 2^252: hi <= 143.
    const int64_t hi = (v[31] >> 4) + v[32] * 16 + v[33] * 4096;
    v[31] &= 0xF;
    v[32] = 0;
#pragma unroll
    for (int j = 0; j < 16; j++) v[j] -= hi * MODL_L[j];  // L's low 16 bytes are delta
#pragma unroll
    for (int i = 0; i < 32; i++) v[i] += MODL_L[i];
    modl_carry_seq(v, 33); // value in (0, 2L), v[32] == 0
    int64_t diff[33];
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 33; i++) {
        const int64_t x = v[i] - (i < 32 ? MODL_L[i] : 0) + borrow;
        borrow = x >> 8;
        diff[i] = x - borrow * 256;
    }
    const bool ge = borrow >= 0;  // no final borrow: value >= L
#pragma unroll
    for (int i = 0; i < 32; i++) out[i] = (uint8_t)(ge ? diff[i] : v[i]);
}
