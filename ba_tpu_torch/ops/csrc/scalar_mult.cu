// K3'': [k]P by double-and-add-always, two threads a lane.
//
// Replaces ba_tpu/ops/ladder.py::_ladder_kernel (:53, through scalar_mult
// at :205, exported as ba_tpu.ops.ladder_scalar_mult), the drop-in for
// ed25519.scalar_mult.  Per lane, for each bit t of k, least significant
// first: sum = acc + q, acc = bit ? sum : acc, q = q + q.  Both additions
// are the complete unified ge_add (9 multiplies), q + q included: the
// contract is the reference's projective coordinates (the canonical X, Y,
// Z and T of ed25519.scalar_mult), and the dedicated doubling ge_dbl gives
// the same point in other coordinates.  The select is a mask on registers
// (ge_cmov), so no thread branches on its bit.
//
// Design.  The two chains are independent but for q_t, which acc's
// addition reads once a bit.  So each lane runs on two adjacent threads of
// a warp: the even one holds q, the odd one acc.  Each bit both take q_t
// from the even thread by 40 __shfl_sync and run the same step,
// k3pp_step: x + q_t, kept under a mask (always for q's thread, at a set
// bit for acc's).  One instruction stream, no divergence: a bit costs one
// addition's chain where one thread a lane ran two, and each thread keeps
// two points and one addition's temporaries (204 registers, no spill,
// where one thread a lane spilled ~180 bytes).  A warp with no live lane
// returns; a partly live one keeps every thread for the shuffles.
//
// Bound: operations.  The least work that keeps the coordinates is, per
// lane, q + q up to k's highest set bit by squarings (4 squarings and 5
// multiplies, ge_add(q, q)'s field values) and acc + q at the set bits
// only (ge_add, 9 multiplies): chip_smoke.k3pp_least_ops, each step at
// the SASS counts of a multiply and a squaring that bound the other
// Ed25519 kernels, with its lazy additions (K3PP_DBL_OPS, K3PP_ADD_OPS).
// A lockstep ladder adds at every bit, so it stays above that (for random
// k, 256 additions where the bits need ~128).  The bytes (128 + nbits / 8
// in and 128 out a lane) are far below.
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

// One thread's step of a bit: x = take ? x + qt : x.  ge_add reads both
// inputs before it writes the sum, so qt may be x (q + q).
ED_FN void k3pp_step(ge& x, const ge& qt, uint32_t take) {
    ge sum;
    ge_add(sum, x, qt);
    ge_cmov(x, sum, take);
}

// One lane on one thread, the kernel's two threads' steps in sequence:
// words holds the lane's nwords words, `stride` apart.
ED_FN void scalar_mult_lane(const uint8_t* pt, const uint32_t* words, int nwords, size_t stride,
                            uint8_t* out) {
    ge q, acc;
    ge_frombytes4(q, pt);
    ge_identity(acc);
#pragma unroll 1
    for (int w = 0; w < nwords; w++) {
        const uint32_t word = words[w * stride];
#pragma unroll 1
        for (int b = 0; b < 32; b++) {
            k3pp_step(acc, q, word >> b);
            k3pp_step(q, q, 1u);
        }
    }
    ge_tobytes4(out, acc);
}

#if defined(__CUDACC__)

constexpr int K3PP_THREADS = 128;  // 64 lanes a block

// Thread 2i + r of the grid: lane i's q (r = 0) or acc (r = 1).
__global__ void __launch_bounds__(K3PP_THREADS) scalar_mult_kernel(
    int n, int nwords, const uint8_t* __restrict__ pt, const uint32_t* __restrict__ words,
    uint8_t* __restrict__ out) {
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    if ((tid & ~31) >= 2 * n) return;  // a warp with no live lane
    const int lane = tid >> 1, r = tid & 1;
    const bool live = lane < n;
    const int src = threadIdx.x & 30;  // the pair's q thread in the warp
    ge x, qt;
    if (r == 0 && live)
        ge_frombytes4(x, pt + 128 * (size_t)lane);
    else
        ge_identity(x);
#pragma unroll 1
    for (int w = 0; w < nwords; w++) {
        const uint32_t word = (r == 1 && live) ? words[w * (size_t)n + lane] : ~0u;
#pragma unroll 1
        for (int b = 0; b < 32; b++) {
            const int32_t* xs = &x.x.v[0];
            int32_t* qs = &qt.x.v[0];
#pragma unroll
            for (int i = 0; i < 40; i++) qs[i] = __shfl_sync(0xffffffffu, xs[i], src);
            k3pp_step(x, qt, word >> b);
        }
    }
    if (r == 1 && live) ge_tobytes4(out + 128 * (size_t)lane, x);
}

extern "C" int ba_scalar_mult(int n, int nwords, const void* pt, const void* words, void* out,
                              void* stream) {
    if (n <= 0) return 0;
    const int blocks = (int)((2 * (long long)n + K3PP_THREADS - 1) / K3PP_THREADS);
    scalar_mult_kernel<<<blocks, K3PP_THREADS, 0, (cudaStream_t)stream>>>(
        n, nwords, (const uint8_t*)pt, (const uint32_t*)words, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
