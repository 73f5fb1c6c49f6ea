// P: the field-multiply probe, eight independent chains of multiplies a
// lane; the measured floor of the card's GF(2^255 - 19) multiply rate.
//
// Replaces the Pallas probe kernel of bench.py (make_fieldmul_probe, its
// kernel at :3404), which runs 8 chains acc_c <- acc_c * b of the
// planes' p_mul, 512 multiplies a lane, to set a floor under the window
// ladder's rate.  Here a lane reads a and b (canonical encodings, bit
// 255 dropped as fe_frombytes drops it), starts chain c at a + c, runs
// PROBE_DEPTH rounds of one fe_mul by b on every chain (independent
// chains: the multiplies of a round overlap), and writes the field sum
// of the chains as its canonical encoding, so the plain version
// (crypto/field.py, ops/fieldmul_probe.py) can be held bit for bit.
//
// Bound: operations, 512 fe_mul a lane (8 x 64).  Bytes: 64 in, 32 out
// a lane.
//
// Interface: a, b uint8 [n, 32] -> out uint8 [n, 32].

#include "ed25519_field.cuh"

#define PROBE_CHAINS 8
#define PROBE_DEPTH 64

ED_FN void fieldmul_probe_lane(const uint8_t* a_enc, const uint8_t* b_enc, uint8_t* out) {
    fe b, acc[PROBE_CHAINS];
    fe_frombytes(b, b_enc);
#pragma unroll
    for (int c = 0; c < PROBE_CHAINS; c++) {
        fe_frombytes(acc[c], a_enc);
        acc[c].v[0] += c;
    }
#pragma unroll 1
    for (int i = 0; i < PROBE_DEPTH; i++) {
#pragma unroll
        for (int c = 0; c < PROBE_CHAINS; c++) fe_mul(acc[c], acc[c], b);
    }
    // The chains' sum in int64 columns, carried back into a field element
    // (eight carried values would pass fe_canonical's input bound).
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        t[i] = 0;
#pragma unroll
        for (int c = 0; c < PROBE_CHAINS; c++) t[i] += acc[c].v[i];
    }
    fe sum;
    fe_reduce64(sum, t);
    fe_tobytes(out, sum);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) fieldmul_probe_kernel(int n, const uint8_t* __restrict__ a,
                                                             const uint8_t* __restrict__ b,
                                                             uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    fieldmul_probe_lane(a + 32 * (size_t)lane, b + 32 * (size_t)lane, out + 32 * (size_t)lane);
}

extern "C" int ba_fieldmul_probe(int n, const void* a, const void* b, void* out, void* stream) {
    if (n <= 0) return 0;
    fieldmul_probe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
