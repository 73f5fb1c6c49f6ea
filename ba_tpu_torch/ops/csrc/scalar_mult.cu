// K3'': [k]P by double-and-add-always, one thread a lane.
//
// Replaces ba_tpu/ops/ladder.py::_ladder_kernel (:53, through scalar_mult
// at :205, exported as ba_tpu.ops.ladder_scalar_mult), the drop-in for
// ed25519.scalar_mult.  Per lane, for each bit t of k, least significant
// first: sum = acc + q, acc = bit ? sum : acc, q = q + q.  Both additions
// are the complete unified ge_add (9 multiplies), q + q included: the
// contract is the reference's projective coordinates (the canonical X, Y,
// Z and T of ed25519.scalar_mult), and the dedicated doubling ge_dbl gives
// the same point in other coordinates.  ge_add reads all of its inputs
// before it writes, so ge_add(q, q, q) is safe.  The select is a mask on
// registers (ge_cmov), so no lane branches on its bit.
//
// Bound: operations, 2 nbits additions of 9 multiplies a lane (4 608 at
// 256 bits, 9 216 at 512), against 128 + nbits / 8 bytes in and 128 out.
// acc, q and the sum (120 int32) and the field temporaries of one
// addition take 255 registers, and ptxas spills ~200 bytes a lane.
//
// Interface: point uint8 [n, 4, 32] (canonical X, Y, Z, T), words int32
// [nbits / 32, n] -> out uint8 [n, 4, 32].  Bit t of lane i's k is bit
// t % 32 of words[t / 32][i]: ladder.py:173 _pack_bits's layout, word
// major, so a warp's loads of one word are coalesced.

#include "ed25519_field.cuh"

// acc = take ? sum : acc, through a mask: no branch on take.
ED_FN void ge_cmov(ge& acc, const ge& sum, uint32_t take) {
    const int32_t mask = -(int32_t)(take & 1u);
    int32_t* a = &acc.x.v[0];
    const int32_t* s = &sum.x.v[0];
#pragma unroll
    for (int i = 0; i < 40; i++) a[i] ^= mask & (a[i] ^ s[i]);
}

// One lane: words holds the lane's nwords words, `stride` apart.
ED_FN void scalar_mult_lane(const uint8_t* pt, const uint32_t* words, int nwords, size_t stride,
                            uint8_t* out) {
    ge q, acc, sum;
    ge_frombytes4(q, pt);
    ge_identity(acc);
#pragma unroll 1
    for (int w = 0; w < nwords; w++) {
        const uint32_t word = words[w * stride];
#pragma unroll 1
        for (int b = 0; b < 32; b++) {
            ge_add(sum, acc, q);
            ge_cmov(acc, sum, word >> b);
            ge_add(q, q, q);
        }
    }
    ge_tobytes4(out, acc);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(64) scalar_mult_kernel(int n, int nwords,
                                                         const uint8_t* __restrict__ pt,
                                                         const uint32_t* __restrict__ words,
                                                         uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    scalar_mult_lane(pt + 128 * (size_t)lane, words + lane, nwords, (size_t)n,
                     out + 128 * (size_t)lane);
}

extern "C" int ba_scalar_mult(int n, int nwords, const void* pt, const void* words, void* out,
                              void* stream) {
    if (n <= 0) return 0;
    scalar_mult_kernel<<<(n + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
        n, nwords, (const uint8_t*)pt, (const uint32_t*)words, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
