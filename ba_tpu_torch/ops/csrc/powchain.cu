// K8: Ed25519 point compression, and the field exponentiations of
// pow_planes: K8' (the (p - 5)/8 chain), the p - 2 chain alone and K8''
// (a generic exponent).  One thread a lane.
//
// Replaces ba_tpu/ops/powchain.py::_inv_chain_kernel (the Pallas TPU
// kernel, reached through pow_planes(z, P - 2) from
// ba_tpu/crypto/ed25519.py::compress) and takes in the rest of compress
// that the reference leaves to XLA (ed25519.py:227-232): from a point
// (X : Y : Z : T) to its 32-byte encoding.  Per lane: 1/Z, x = X / Z and
// y = Y / Z, then the canonical y with the low bit of the canonical x in
// bit 255.  Z = 0 mod p (no point of the curve) gives 1/Z = 0 and the
// encoding of (0, 0), as the plain version does.
//
// Bound: operations, against 160 bytes moved (128 in, 32 out).  The
// inverse is unique, so any route gives the plain version's bits; K8 takes
// Bernstein and Yang's constant-time divsteps (safegcd.cuh:
// fe_inv_safegcd), ~2.3x fewer instructions than the 2^k - 1 chain
// (fe_inv_chain: 257 squarings and 15 multiplies in one dependent chain)
// and shorter dependent runs, which is what one lane at a few warps a SM
// waits on (2 lanes in verify_rlc's comparison, 20 480 in the setups).
// 32-thread blocks spread the setups' 640 warps evenly over the SMs.
//
// Interface: pts uint8 [n, 4, 32] (canonical X, Y, Z, T; T is not read)
// -> enc uint8 [n, 32].
//
// pow_planes (ba_tpu/ops/powchain.py:130, the drop-in for field.pow_const)
// routes a^e to three kernels, each on field elements as 32-byte
// little-endian encodings (the low 255 bits read), uint8 [n, 32] ->
// uint8 [n, 32] canonical:
// - K8' replaces _sqrt_chain_kernel (:94): e = (p - 5)/8 by the addition
//   chain fe_sqrt_chain, 251 squarings and 11 multiplies;
// - the p - 2 route replaces _inv_chain_kernel (:101) on its own: 1/a by
//   fe_inv_chain, 257 squarings and 13 multiplies (K8 without the rest of
//   compress);
// - K8'' replaces _pow_kernel (:108): any other e by square-and-multiply
//   over its bits, least significant first.  The bits are the same in
//   every lane, so a zero bit skips its multiply (a uniform branch) and
//   the last squaring is not made: nbits - 1 squarings and popcount(e)
//   multiplies.  The exponent's words come in the launch's parameters
//   (PowExp), up to POW_MAX_WORDS of them; e = 0 gives 1, as pow_const.
// Bound: operations; 64 bytes a lane.

#include "ed25519_field.cuh"
#include "safegcd.cuh"

ED_FN void compress_lane(const uint8_t* pt, uint8_t* enc) {
    fe x, y, z, zi;
    fe_frombytes(x, pt);
    fe_frombytes(y, pt + 32);
    fe_frombytes(z, pt + 64);
    fe_inv_safegcd(zi, z);
    fe_mul(x, x, zi);
    fe_mul(y, y, zi);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    fe_tobytes(enc, y);
    enc[31] |= (uint8_t)((xb[0] & 1) << 7);
}

ED_FN void sqrt_chain_lane(const uint8_t* a, uint8_t* out) {
    fe z, r;
    fe_frombytes(z, a);
    fe_sqrt_chain(r, z);
    fe_tobytes(out, r);
}

ED_FN void inv_chain_lane(const uint8_t* a, uint8_t* out) {
    fe z, r;
    fe_frombytes(z, a);
    fe_inv_chain(r, z);
    fe_tobytes(out, r);
}

#define POW_MAX_WORDS 32  // exponents of up to 1024 bits

struct PowExp {
    uint32_t w[POW_MAX_WORDS];
};

ED_FN void pow_lane(const uint8_t* a, int nbits, const uint32_t* w, uint8_t* out) {
    fe base, r;
    fe_frombytes(base, a);
    fe_1(r);
#pragma unroll 1
    for (int t = 0; t < nbits; t++) {
        if (t) fe_sq(base, base);
        if ((w[t >> 5] >> (t & 31)) & 1u) fe_mul(r, r, base);
    }
    fe_tobytes(out, r);
}

#if defined(__CUDACC__)

constexpr int COMPRESS_BLOCK = 32;

__global__ void __launch_bounds__(COMPRESS_BLOCK) compress_kernel(
    int n, const uint8_t* __restrict__ pts, uint8_t* __restrict__ enc) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    compress_lane(pts + 128 * (size_t)lane, enc + 32 * (size_t)lane);
}

extern "C" int ba_compress(int n, const void* pts, void* enc, void* stream) {
    if (n <= 0) return 0;
    compress_kernel<<<(n + COMPRESS_BLOCK - 1) / COMPRESS_BLOCK, COMPRESS_BLOCK, 0,
                      (cudaStream_t)stream>>>(n, (const uint8_t*)pts, (uint8_t*)enc);
    return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(64) sqrt_chain_kernel(int n, const uint8_t* __restrict__ a,
                                                        uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    sqrt_chain_lane(a + 32 * (size_t)lane, out + 32 * (size_t)lane);
}

__global__ void __launch_bounds__(64) inv_chain_kernel(int n, const uint8_t* __restrict__ a,
                                                       uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    inv_chain_lane(a + 32 * (size_t)lane, out + 32 * (size_t)lane);
}

__global__ void __launch_bounds__(64) pow_kernel(int n, int nbits, const PowExp e,
                                                 const uint8_t* __restrict__ a,
                                                 uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    pow_lane(a + 32 * (size_t)lane, nbits, e.w, out + 32 * (size_t)lane);
}

extern "C" int ba_sqrt_chain(int n, const void* a, void* out, void* stream) {
    if (n <= 0) return 0;
    sqrt_chain_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int ba_inv_chain(int n, const void* a, void* out, void* stream) {
    if (n <= 0) return 0;
    inv_chain_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (uint8_t*)out);
    return (int)cudaGetLastError();
}

// words: the exponent's ceil(nbits / 32) words, least significant first,
// in host memory; copied into the launch's parameters.
extern "C" int ba_pow(int n, int nbits, const uint32_t* words, const void* a, void* out,
                      void* stream) {
    if (nbits < 0 || nbits > 32 * POW_MAX_WORDS) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    PowExp e = {};
    for (int i = 0; i < (nbits + 31) / 32; i++) e.w[i] = words[i];
    pow_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(n, nbits, e, (const uint8_t*)a,
                                                               (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
