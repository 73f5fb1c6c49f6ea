// Variants of K7 (ba_tpu_torch/ops/csrc/decompress.cu) that
// scripts/k4k7_variants.py builds and times: the shipped kernel's lane,
// split around the (p - 5)/8 chain so that N lanes a thread can run their
// chains interleaved, with every product reduced in either carry order.
// The shipped kernel runs one lane a thread and the serial order; these
// lost on an H100 (PERF.md, the K4 and K7 redesign).
//
// -D flags: K7_CARRY (FE_CARRY_SERIAL or FE_CARRY_TWO_CHAINS), K7_LANES
// (1 or 2), K7_BLOCK (threads a block), and K7_CAP_FROM and K7_CAP_BLOCKS
// (the lane count from which the instance bounded to K7_CAP_BLOCKS blocks
// a SM runs, 0 for always).  The interface is the shipped one:
// ba_decompress(n, enc, pts, ok, stream).
//
// fe_mul_c and fe_sq_c are the header's fe_mul and fe_sq with
// fe_reduce64_c's carry order.  The header's bound on a carried output
// (u <= 1/2 + 2^-8) holds under either order: a column is below 2^62.6
// (fe_mul's limit), so a first carry is below 2^37.6, and ref10's two
// interleaved chains leave limb 5 off by < 2^12 (limb 4's second carry,
// of at most (2^25 + 2^37.6) / 2^26) and limb 1 off by < 2^16 (limb 0's
// second, of at most (2^25 + 19 * 2^37.6) / 2^26); every other limb ends
// in [-2^(b-1), 2^(b-1)), and no sum leaves int64.

#include "ed25519_field.cuh"

// The rounding carry of int64 column k into column k + 1 (column 9's
// into column 0, times 19).
ED_FN void fe_carry64(int64_t t[10], int k) {
    const int b = FE_B(k);
    const int64_t c = (t[k] + ((int64_t)1 << (b - 1))) >> b;
    t[k] -= c * ((int64_t)1 << b);
    if (k < 9)
        t[k + 1] += c;
    else
        t[0] += 19 * c;
}

// The carry orders of fe_reduce64_c: FE_CARRY_SERIAL, one sequential chain
// 0 -> 9, limb 9's carry back into limb 0 times 19, then one more carry
// out of limb 0 (12 dependent steps); FE_CARRY_TWO_CHAINS, ref10's order,
// the chains 0 -> 5 and 4 -> 9 interleaved, then 9 -> 0 and 0 -> 1 (7
// steps deep).  The value mod p is the same, so canonical forms agree.
constexpr int FE_CARRY_SERIAL = 0;
constexpr int FE_CARRY_TWO_CHAINS = 1;

// Rounding carries of int64 columns into a carried fe, in CARRY's order.
template <int CARRY = FE_CARRY_SERIAL>
ED_FN void fe_reduce64_c(fe& h, int64_t t[10]) {
    if constexpr (CARRY == FE_CARRY_TWO_CHAINS) {
#pragma unroll
        for (int k = 0; k < 5; k++) {
            fe_carry64(t, k);
            fe_carry64(t, k + 4);
        }
        fe_carry64(t, 9);
    } else {
#pragma unroll
        for (int k = 0; k < 10; k++) fe_carry64(t, k);
    }
    fe_carry64(t, 0);
#pragma unroll
    for (int k = 0; k < 10; k++) h.v[k] = (int32_t)t[k];
}

// h = f * g; needs u(f) * u(g) <= 9 (header comment); h carried.
template <int CARRY = FE_CARRY_SERIAL>
ED_FN void fe_mul_c(fe& h, const fe& f, const fe& g) {
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
    fe_reduce64_c<CARRY>(h, t);
}

// h = f^2; needs u(f) <= 3 (as fe_mul with g = f); h carried.  55
// products: each f_i f_j with i < j once, at twice its weight (four
// times for odd i and j), and the 10 squares (twice for odd i).  The
// premultiplied limbs stay in int32: |4 f_i| < 12 * 2^25 for odd i.
template <int CARRY = FE_CARRY_SERIAL>
ED_FN void fe_sq_c(fe& h, const fe& f) {
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
    fe_reduce64_c<CARRY>(h, t);
}

// N lanes' chains side by side: each step runs on every lane before the
// next, so the lanes' dependent squarings interleave (N = 1: one chain).
template <int N, int CARRY>
ED_FN void fe_sq_n_lanes(fe* h, const fe* f, int n) {
#pragma unroll
    for (int l = 0; l < N; l++) h[l] = f[l];
#pragma unroll 1
    for (int i = 0; i < n; i++) {
#pragma unroll
        for (int l = 0; l < N; l++) fe_sq_c<CARRY>(h[l], h[l]);
    }
}

template <int N, int CARRY>
ED_FN void fe_mul_lanes(fe* h, const fe* f, const fe* g) {
#pragma unroll
    for (int l = 0; l < N; l++) fe_mul_c<CARRY>(h[l], f[l], g[l]);
}

// The 2^k - 1 tower (ba_tpu/ops/powchain.py:48): z^(2^250 - 1), N lanes.
template <int N, int CARRY>
ED_FN void fe_tower_250_lanes(fe* out, const fe* z) {
    fe t2[N], t4[N], t5[N], t10[N], t20[N], t40[N], t50[N], t100[N], s[N];
    fe_sq_n_lanes<N, CARRY>(s, z, 1);     fe_mul_lanes<N, CARRY>(t2, s, z);
    fe_sq_n_lanes<N, CARRY>(s, t2, 2);    fe_mul_lanes<N, CARRY>(t4, s, t2);
    fe_sq_n_lanes<N, CARRY>(s, t4, 1);    fe_mul_lanes<N, CARRY>(t5, s, z);
    fe_sq_n_lanes<N, CARRY>(s, t5, 5);    fe_mul_lanes<N, CARRY>(t10, s, t5);
    fe_sq_n_lanes<N, CARRY>(s, t10, 10);  fe_mul_lanes<N, CARRY>(t20, s, t10);
    fe_sq_n_lanes<N, CARRY>(s, t20, 20);  fe_mul_lanes<N, CARRY>(t40, s, t20);
    fe_sq_n_lanes<N, CARRY>(s, t40, 10);  fe_mul_lanes<N, CARRY>(t50, s, t10);
    fe_sq_n_lanes<N, CARRY>(s, t50, 50);  fe_mul_lanes<N, CARRY>(t100, s, t50);
    fe_sq_n_lanes<N, CARRY>(s, t100, 100); fe_mul_lanes<N, CARRY>(s, s, t100);  // t200
    fe_sq_n_lanes<N, CARRY>(s, s, 50);    fe_mul_lanes<N, CARRY>(out, s, t50);
}

// z^((p-5)/8) = z^(2^252 - 3) = t_250^4 * z (ba_tpu/ops/powchain.py:68), N lanes.
template <int N, int CARRY>
ED_FN void fe_sqrt_chain_lanes(fe* out, const fe* z) {
    fe t[N];
    fe_tower_250_lanes<N, CARRY>(t, z);
    fe_sq_n_lanes<N, CARRY>(t, t, 2);
    fe_mul_lanes<N, CARRY>(out, t, z);
}


#ifndef K7_CARRY
#define K7_CARRY FE_CARRY_SERIAL
#endif
#ifndef K7_LANES
#define K7_LANES 1
#endif
#ifndef K7_BLOCK
#define K7_BLOCK 64
#endif
#ifndef K7_CAP_FROM
#define K7_CAP_FROM 32768
#endif
#ifndef K7_CAP_BLOCKS
#define K7_CAP_BLOCKS 8
#endif

// p's little-endian bytes are ed ff .. ff 7f: y (bit 255 cleared) < p
// unless bytes 1..30 are all 0xff, byte 31 is 0x7f and byte 0 >= 0xed.
ED_FN bool y_below_p(const uint8_t y[32]) {
    bool top = (y[31] == 0x7f);
#pragma unroll
    for (int i = 1; i < 31; i++) top = top && (y[i] == 0xff);
    return !(top && y[0] >= 0xed);
}

// What a lane keeps across the chain.
struct DecompressLane {
    fe y, u, v, v3;
    int sign;
    bool ok;
};

// Up to the chain: y, u, v, v^3 and the chain's input u v^7.
template <int CARRY>
ED_FN void decompress_start(DecompressLane& s, fe& z, const uint8_t* enc) {
    uint8_t yb[32];
#pragma unroll
    for (int i = 0; i < 32; i++) yb[i] = enc[i];
    s.sign = yb[31] >> 7;
    yb[31] &= 0x7f;
    s.ok = y_below_p(yb);

    fe yy, one, v7, c;
    fe_frombytes(s.y, yb);
    fe_1(one);
    fe_sq_c<CARRY>(yy, s.y);
    fe_sub(s.u, yy, one);
    fe_load(c, FE_D_LIMBS);
    fe_mul_c<CARRY>(s.v, yy, c);
    fe_add(s.v, s.v, one);
    fe_sq_c<CARRY>(s.v3, s.v);
    fe_mul_c<CARRY>(s.v3, s.v3, s.v);
    fe_sq_c<CARRY>(v7, s.v3);
    fe_mul_c<CARRY>(v7, v7, s.v);
    fe_mul_c<CARRY>(z, s.u, v7);
}

// After the chain (t = (u v^7)^((p-5)/8)): the root, the sign, the point.
template <int CARRY>
ED_FN void decompress_finish(const DecompressLane& s, const fe& t, uint8_t* pt, uint8_t* ok_out) {
    fe x, x_alt, vxx, neg_u, c, one;
    fe_mul_c<CARRY>(x, s.u, s.v3);
    fe_mul_c<CARRY>(x, x, t);
    fe_load(c, FE_SQRTM1_LIMBS);
    fe_mul_c<CARRY>(x_alt, x, c);
    fe_sq_c<CARRY>(vxx, x);
    fe_mul_c<CARRY>(vxx, s.v, vxx);

    const bool root1 = fe_eq(vxx, s.u);
    fe_neg(neg_u, s.u);
    const bool root2 = fe_eq(vxx, neg_u);
    fe_select(x, x_alt, x, root2);
    bool ok = s.ok && (root1 || root2);

    uint8_t xb[32];
    fe_tobytes(xb, x);
    bool x_zero = true;
#pragma unroll
    for (int i = 0; i < 32; i++) x_zero = x_zero && (xb[i] == 0);
    ok = ok && !(x_zero && s.sign == 1);
    fe xc;
    fe_frombytes(xc, xb);
    if ((xb[0] & 1) != s.sign) {
        fe_neg(xc, xc);
        fe_tobytes(xb, xc);
        fe_frombytes(xc, xb);
    }
    fe xy;
    fe_mul_c<CARRY>(xy, xc, s.y);
    fe_1(one);
#pragma unroll
    for (int i = 0; i < 32; i++) pt[i] = xb[i];
    fe_tobytes(pt + 32, s.y);
    fe_tobytes(pt + 64, one);
    fe_tobytes(pt + 96, xy);
    *ok_out = ok ? 1 : 0;
}

// Lanes first .. first + N - 1 of n, their chains interleaved; a lane past
// n - 1 runs lane n - 1's and writes nothing.
template <int N, int CARRY>
ED_FN void decompress_lanes(int n, int first, const uint8_t* enc, uint8_t* pts, uint8_t* ok) {
    DecompressLane s[N];
    fe z[N], t[N];
#pragma unroll
    for (int l = 0; l < N; l++) {
        const int lane = first + l < n ? first + l : n - 1;
        decompress_start<CARRY>(s[l], z[l], enc + 32 * (size_t)lane);
    }
    fe_sqrt_chain_lanes<N, CARRY>(t, z);
#pragma unroll
    for (int l = 0; l < N; l++) {
        const int lane = first + l;
        if (lane < n) decompress_finish<CARRY>(s[l], t[l], pts + 128 * (size_t)lane, ok + lane);
    }
}

#if defined(__CUDACC__)

template <int MIN_BLOCKS>
__global__ void __launch_bounds__(K7_BLOCK, MIN_BLOCKS)
    decompress_kernel(int n, const uint8_t* __restrict__ enc, uint8_t* __restrict__ pts,
                      uint8_t* __restrict__ ok) {
    const int first = K7_LANES * (blockIdx.x * blockDim.x + threadIdx.x);
    if (first >= n) return;
    decompress_lanes<K7_LANES, K7_CARRY>(n, first, enc, pts, ok);
}

extern "C" int ba_decompress(int n, const void* enc, void* pts, void* ok, void* stream) {
    if (n <= 0) return 0;
    const int threads = (n + K7_LANES - 1) / K7_LANES;
    const int grid = (threads + K7_BLOCK - 1) / K7_BLOCK;
    if (n >= K7_CAP_FROM)
        decompress_kernel<K7_CAP_BLOCKS><<<grid, K7_BLOCK, 0, (cudaStream_t)stream>>>(
            n, (const uint8_t*)enc, (uint8_t*)pts, (uint8_t*)ok);
    else
        decompress_kernel<1><<<grid, K7_BLOCK, 0, (cudaStream_t)stream>>>(
            n, (const uint8_t*)enc, (uint8_t*)pts, (uint8_t*)ok);
    return (int)cudaGetLastError();
}

#endif
