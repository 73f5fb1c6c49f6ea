// K7: Ed25519 point decompression (RFC 8032 5.1.3), one thread a lane.
//
// Replaces ba_tpu/ops/decompress.py::_decompress_kernel (the Pallas TPU
// kernel) and takes in the root choice that the reference leaves to XLA
// (ba_tpu/crypto/ed25519.py:257-287): from a 32-byte encoding to the
// point (X, Y, 1, X Y), every coordinate canonical, and the validity
// verdict.  Per lane: y from the low 255 bits (valid only if y < p),
// u = y^2 - 1, v = d y^2 + 1, x = u v^3 (u v^7)^((p-5)/8) through the
// 2^k - 1 tower, x sqrt(-1) and v x^2; the root whose square matches
// (+u: x, -u: x sqrt(-1), which wins when both match); no root -> invalid;
// x = 0 with sign bit 1 -> invalid; then x is negated when its parity
// differs from the sign bit.  An invalid lane's point is what these steps
// give, canonical like any other (the plain version gives the same).
//
// Bound: operations.  275 field products a lane, 255 of them squarings
// (251 squarings and 11 multiplies in the chain, 4 and 9 around it), ~5
// canonical forms, and 32 bytes in and 129 out.  The chain is one lane's
// serial line of products: at the setups' lane counts (20 480 to 30 720,
// a few warps a SM) its latency is the kernel's time, and above them the
// warps a SM are.  One thread a lane, 64-thread blocks.  Below
// CAP_FROM_LANES lanes the instance that may take 255 registers (no
// spill) runs; from it the one whose __launch_bounds__ asks for 8 blocks
// a SM (128 registers, some spill, twice the warps): 0.80 against 0.90 ms
// at 131 072 lanes on an H100, 0.21 either way at 20 480.  Ref10's two
// interleaved carry chains a product ran 2-5 % slower than the serial one
// at every lane count, two lanes a thread with their chains interleaved
// 5-60 % slower, 32- or 128-thread blocks within 1 %
// (scripts/k4k7_variants.py, which carries those variants' sources).
//
// Interface: enc uint8 [n, 32] -> pts uint8 [n, 4, 32], ok uint8 [n].

#include "ed25519_field.cuh"

// p's little-endian bytes are ed ff .. ff 7f: y (bit 255 cleared) < p
// unless bytes 1..30 are all 0xff, byte 31 is 0x7f and byte 0 >= 0xed.
ED_FN bool y_below_p(const uint8_t y[32]) {
    bool top = (y[31] == 0x7f);
#pragma unroll
    for (int i = 1; i < 31; i++) top = top && (y[i] == 0xff);
    return !(top && y[0] >= 0xed);
}

ED_FN void decompress_lane(const uint8_t* enc, uint8_t* pt, uint8_t* ok_out) {
    uint8_t yb[32];
#pragma unroll
    for (int i = 0; i < 32; i++) yb[i] = enc[i];
    const int sign = yb[31] >> 7;
    yb[31] &= 0x7f;
    bool ok = y_below_p(yb);

    fe y, yy, one, u, v, v3, v7, t, x, x_alt, vxx, neg_u, c;
    fe_frombytes(y, yb);
    fe_1(one);
    fe_sq(yy, y);
    fe_sub(u, yy, one);
    fe_load(c, FE_D_LIMBS);
    fe_mul(v, yy, c);
    fe_add(v, v, one);
    fe_sq(v3, v);
    fe_mul(v3, v3, v);
    fe_sq(v7, v3);
    fe_mul(v7, v7, v);
    fe_mul(t, u, v7);
    fe_sqrt_chain(t, t);
    fe_mul(x, u, v3);
    fe_mul(x, x, t);
    fe_load(c, FE_SQRTM1_LIMBS);
    fe_mul(x_alt, x, c);
    fe_sq(vxx, x);
    fe_mul(vxx, v, vxx);

    const bool root1 = fe_eq(vxx, u);
    fe_neg(neg_u, u);
    const bool root2 = fe_eq(vxx, neg_u);
    fe_select(x, x_alt, x, root2);
    ok = ok && (root1 || root2);

    uint8_t xb[32];
    fe_tobytes(xb, x);
    bool x_zero = true;
#pragma unroll
    for (int i = 0; i < 32; i++) x_zero = x_zero && (xb[i] == 0);
    ok = ok && !(x_zero && sign == 1);
    fe xc;
    fe_frombytes(xc, xb);
    if ((xb[0] & 1) != sign) {
        fe_neg(xc, xc);
        fe_tobytes(xb, xc);
        fe_frombytes(xc, xb);
    }
    fe xy;
    fe_mul(xy, xc, y);
#pragma unroll
    for (int i = 0; i < 32; i++) pt[i] = xb[i];
    fe_tobytes(pt + 32, y);
    fe_tobytes(pt + 64, one);
    fe_tobytes(pt + 96, xy);
    *ok_out = ok ? 1 : 0;
}

#if defined(__CUDACC__)

// From this many lanes the instance bounded to 8 blocks a SM runs.
constexpr int CAP_FROM_LANES = 32768;

template <int MIN_BLOCKS>
__global__ void __launch_bounds__(64, MIN_BLOCKS)
    decompress_kernel(int n, const uint8_t* __restrict__ enc, uint8_t* __restrict__ pts,
                      uint8_t* __restrict__ ok) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    decompress_lane(enc + 32 * (size_t)lane, pts + 128 * (size_t)lane, ok + lane);
}

extern "C" int ba_decompress(int n, const void* enc, void* pts, void* ok, void* stream) {
    if (n <= 0) return 0;
    const int grid = (n + 63) / 64;
    cudaStream_t st = (cudaStream_t)stream;
    if (n >= CAP_FROM_LANES)
        decompress_kernel<8><<<grid, 64, 0, st>>>(n, (const uint8_t*)enc, (uint8_t*)pts,
                                                  (uint8_t*)ok);
    else
        decompress_kernel<1><<<grid, 64, 0, st>>>(n, (const uint8_t*)enc, (uint8_t*)pts,
                                                  (uint8_t*)ok);
    return (int)cudaGetLastError();
}

#endif
