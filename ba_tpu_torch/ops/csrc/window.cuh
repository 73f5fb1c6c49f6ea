// The 4-bit window accumulator shared by K3 (window_verify.cu) and K3'
// (window_mult.cu): the body of ba_tpu/ops/ladder.py::_window_acc.
//
// acc = [k]P for the little-endian scalar k of NBYTES bytes: the 16
// multiples T[j] = [j]P (14 additions), then 2 NBYTES windows, most
// significant first, each 4 doublings (the dedicated formula, T only on
// the fourth) and one addition of T[d_w], d_w the w-th 4-bit digit of k.
// A zero digit adds T[0], the identity, so k = 0 gives the identity
// whatever P is.  Work: 14 x 9 multiplies for the table, and per window
// 26 multiplies and 12 squarings (3 doublings of 4 and 3, one of 5 and
// 3, an addition of 9).  The table (16 points, 2.5 kB) is indexed by the
// digit, so on the card it lives in local memory, which L1 holds.
// NBYTES is a template parameter, so the window loop has a trip count
// known at compile time in every kernel that runs it.

#pragma once
#include "ed25519_field.cuh"

template <int NBYTES>
ED_FN void window_acc(ge& acc, const ge& p, const uint8_t* k) {
    ge tab[16];
    ge_identity(tab[0]);
    tab[1] = p;
#pragma unroll 1
    for (int j = 2; j < 16; j++) ge_add(tab[j], tab[j - 1], tab[1]);
    ge_identity(acc);
#pragma unroll 1
    for (int w = 2 * NBYTES - 1; w >= 0; w--) {
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, false);
        ge_dbl(acc, acc, true);
        const int digit = (k[w >> 1] >> (4 * (w & 1))) & 15;
        ge_add(acc, acc, tab[digit]);
    }
}
