// K6: a 512-bit little-endian value mod L, one thread a lane.
//
// Replaces ba_tpu/ops/modl.py::_modl_kernel (the Pallas TPU kernel): the
// word-form reduction of modl.cuh (shared with K5) on the 64 bytes of each
// lane.  On the signing path the input is k * a + r (the unreduced S of
// ba_tpu/crypto/scalar.py::muladd_bytes) and the output S; verify_rlc
// reduces its products and sums with it.
//
// Bound: bytes at width.  A lane is four 16-byte vector loads (its 64
// bytes are the 16 words the reduction takes, no byte decoding), ~50 word
// products and two 16-byte stores: a few hundred integer instructions
// against 96 bytes moved.  At a few lanes the launch is the time.
//
// Interface: in uint8 [n, 64] -> out uint8 [n, 32], both little endian,
// each base 16-byte aligned (the wrapper checks).

#include "modl.cuh"

ED_FN void modl_lane(const modl_vec* in, modl_vec* out) {
    modl_vec x[4], r[2];
#pragma unroll
    for (int k = 0; k < 4; k++) x[k] = in[k];
    modl_vecs(x, r);
    out[0] = r[0];
    out[1] = r[1];
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) modl_kernel(int n, const modl_vec* __restrict__ in,
                                                   modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    modl_lane(in + 4 * (size_t)lane, out + 2 * (size_t)lane);
}

extern "C" int ba_modl(int n, const void* in, void* out, void* stream) {
    if (n <= 0) return 0;
    modl_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        n, (const modl_vec*)in, (modl_vec*)out);
    return (int)cudaGetLastError();
}

#endif
