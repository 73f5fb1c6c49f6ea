// K8: Ed25519 point compression through the p - 2 inversion chain, one
// thread a lane.
//
// Replaces ba_tpu/ops/powchain.py::_inv_chain_kernel (the Pallas TPU
// kernel, reached through pow_planes(z, P - 2) from
// ba_tpu/crypto/ed25519.py::compress) and takes in the rest of compress
// that the reference leaves to XLA (ed25519.py:227-232): from a point
// (X : Y : Z : T) to its 32-byte encoding.  Per lane: 1/Z by the 2^k - 1
// tower (fe_inv_chain: t_250^32 * Z^11), x = X / Z and y = Y / Z, then
// the canonical y with the low bit of the canonical x in bit 255.  Z = 0
// (no point of the curve) gives 1/Z = 0 and the encoding of (0, 0), as
// the plain version does.
//
// Bound: operations.  257 squarings and 15 multiplies a lane, and three
// canonical forms, against 160 bytes moved (128 in, 32 out).  The design
// keeps the chain in registers; its squaring runs are loops
// (fe_sq_n, #pragma unroll 1), so the code stays small.
//
// Interface: pts uint8 [n, 4, 32] (canonical X, Y, Z, T; T is not read)
// -> enc uint8 [n, 32].

#include "ed25519_field.cuh"

ED_FN void compress_lane(const uint8_t* pt, uint8_t* enc) {
    fe x, y, z, zi;
    fe_frombytes(x, pt);
    fe_frombytes(y, pt + 32);
    fe_frombytes(z, pt + 64);
    fe_inv_chain(zi, z);
    fe_mul(x, x, zi);
    fe_mul(y, y, zi);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    fe_tobytes(enc, y);
    enc[31] |= (uint8_t)((xb[0] & 1) << 7);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(64) compress_kernel(int n, const uint8_t* __restrict__ pts,
                                                      uint8_t* __restrict__ enc) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    compress_lane(pts + 128 * (size_t)lane, enc + 32 * (size_t)lane);
}

extern "C" int ba_compress(int n, const void* pts, void* enc, void* stream) {
    if (n <= 0) return 0;
    compress_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)pts, (uint8_t*)enc);
    return (int)cudaGetLastError();
}

#endif
