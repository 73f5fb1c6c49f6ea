// q + q by squarings, the doubling K3''s bound counts
// (chip_smoke.K3PP_DBL_OPS) and the q chain of the variants sq and pair
// (scalar_mult_variants.cu).  No shipped kernel runs it: the shipped K3''
// runs q + q through ge_add, since both threads of a lane share one
// instruction stream.  tests/torch_csrc_host.cpp holds it against ge_add.
//
// r = p + p in ge_add(r, p, p)'s coordinates: with equal inputs the
// unified formula's products are A = (Y - X)^2, B = (Y + X)^2, C = 2d T^2
// and D = 2 Z^2, then E F, G H, F G and E H as in ge_add: 4 squarings and
// 5 multiplies where ge_add takes 9 multiplies.  The field values are
// ge_add's, so the canonical encodings are too (the dedicated ge_dbl gives
// the same point in other coordinates).  Y - X and Y + X of carried or
// canonical limbs have u < 2, inside fe_sq's 3.  All of p is read before r
// is written, so r may be p.  With OPAQUE, 2d's limbs pass through an
// empty asm, so that C's product is a generic multiply and not one by
// constants (the probe's form).

#pragma once
#include "ed25519_field.cuh"

template <bool OPAQUE = false>
ED_FN void ge_add_self(ge& r, const ge& p) {
    fe a, b, c, d, e, f, g, h, s, d2;
    fe_sub(s, p.y, p.x);
    fe_sq(a, s);
    fe_add(s, p.y, p.x);
    fe_sq(b, s);
    fe_sq(c, p.t);
    fe_load(d2, FE_D2_LIMBS);
#if defined(__CUDACC__)
    if (OPAQUE) {
#pragma unroll
        for (int i = 0; i < 10; i++) asm volatile("" : "+r"(d2.v[i]));
    }
#endif
    fe_mul(c, c, d2);
    fe_sq(d, p.z);
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
