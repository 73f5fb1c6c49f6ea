// K6: a 512-bit little-endian value mod L, one thread a lane.
//
// Replaces ba_tpu/ops/modl.py::_modl_kernel (the Pallas TPU kernel): the
// fold plan of modl_core (modl.cuh, shared with K5) on the 64 bytes of
// each lane.  On the signing path the input is k * a + r (the unreduced S
// of ba_tpu/crypto/scalar.py::muladd_bytes) and the output S.
//
// Bound: operations.  ~900 int64 multiply-adds and ~150 carry steps a
// lane (~1.8k int32 operations), against 96 bytes moved.  The design keeps
// the 64 limbs in registers, or in local memory where ptxas puts them.
//
// Interface: in uint8 [n, 64] -> out uint8 [n, 32], both little endian.

#include "modl.cuh"

ED_FN void modl_lane(const uint8_t* in, uint8_t* out) {
    int64_t v[64];
#pragma unroll
    for (int i = 0; i < 64; i++) v[i] = in[i];
    modl_core(v, out);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) modl_kernel(int n, const uint8_t* __restrict__ in,
                                                   uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    modl_lane(in + 64 * (size_t)lane, out + 32 * (size_t)lane);
}

extern "C" int ba_modl(int n, const void* in, void* out, void* stream) {
    if (n <= 0) return 0;
    modl_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)in, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
