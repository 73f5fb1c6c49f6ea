// K4: the fixed-base product [S]B, 64 window points folded by complete
// additions; eight threads a lane.
//
// Replaces ba_tpu/ops/treeadd.py::_tree8_kernel (the Pallas TPU kernel),
// which folds the 64 window points of a lane in two grid levels of an
// 8-to-1 tree, and the one-hot gather that feeds it, which the reference
// leaves to XLA (ba_tpu/crypto/ed25519.py:174-192): this kernel gathers
// its points itself from the window table in device memory.  S =
// sum_w d_w 16^w with d_w the w-th 4-bit digit of the little-endian
// scalar, and T[w][d] = [d 16^w]B, affine (Z = 1).  Thread `part` of a
// lane folds windows 8 part .. 8 part + 7 as the TPU kernel's first level
// does, ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)); three warp-shuffle
// levels then fold the eight partials in the same pairing, the second
// level.  Both partners of a shuffle compute the same sum (lower part
// first), so the lane's result is one fixed tree, as the plain version's.
//
// Bound: operations: 63 additions a lane, 32 of two table entries at 8
// multiplies and 31 at 9 (535); the shuffle levels compute 3 of them twice.  Bytes: 32 in, 128 out a lane;
// the table (131 kB) stays in L2.  Eight threads a lane give the card
// eight times the threads of a thread-a-lane fold.
//
// Interface: s uint8 [n, 32], table uint8 [64, 16, 4, 32] (the canonical
// encodings of T[w][d]) -> out uint8 [n, 4, 32], canonical.

#include "ed25519_field.cuh"

ED_FN void table_entry(ge& e, const uint8_t* table, const uint8_t* s, int w) {
    const int digit = (s[w >> 1] >> (4 * (w & 1))) & 15;
    ge_frombytes4(e, table + (size_t)(w * 16 + digit) * 128);
}

// Windows 8 part .. 8 part + 7 of one lane as a balanced tree; the four
// additions of table entries skip Z1 Z2 (both are 1).
ED_FN void tree8_part(ge& out, const uint8_t* table, const uint8_t* s, int part) {
    const int w = 8 * part;
    ge a, b, c;
    table_entry(a, table, s, w);
    table_entry(b, table, s, w + 1);
    ge_add(a, a, b, true);
    table_entry(b, table, s, w + 2);
    table_entry(c, table, s, w + 3);
    ge_add(b, b, c, true);
    ge_add(a, a, b);
    table_entry(b, table, s, w + 4);
    table_entry(c, table, s, w + 5);
    ge_add(b, b, c, true);
    table_entry(c, table, s, w + 6);
    table_entry(out, table, s, w + 7);
    ge_add(c, c, out, true);
    ge_add(b, b, c);
    ge_add(out, a, b);
}

ED_FN void ge_select(ge& r, const ge& p, const ge& q, bool take_p) {
    fe_select(r.x, p.x, q.x, take_p);
    fe_select(r.y, p.y, q.y, take_p);
    fe_select(r.z, p.z, q.z, take_p);
    fe_select(r.t, p.t, q.t, take_p);
}

#if defined(__CUDACC__)

__device__ __forceinline__ void fe_shfl_xor(fe& h, const fe& f, int m) {
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = __shfl_xor_sync(0xffffffffu, f.v[i], m);
}

__global__ void __launch_bounds__(128) fixed_base_kernel(int n, const uint8_t* __restrict__ s_enc,
                                                         const uint8_t* __restrict__ table,
                                                         uint8_t* __restrict__ out) {
    const int gt = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = gt >> 3, part = gt & 7;
    // Threads past the last lane fold lane n - 1 too: every thread of a
    // warp takes part in the shuffles.  They write nothing.
    const int src = lane < n ? lane : n - 1;
    ge acc;
    tree8_part(acc, table, s_enc + 32 * (size_t)src, part);
#pragma unroll 1
    for (int m = 1; m < 8; m <<= 1) {
        ge other, lo, hi;
        fe_shfl_xor(other.x, acc.x, m);
        fe_shfl_xor(other.y, acc.y, m);
        fe_shfl_xor(other.z, acc.z, m);
        fe_shfl_xor(other.t, acc.t, m);
        const bool upper = (part & m) != 0;
        ge_select(lo, other, acc, upper);
        ge_select(hi, acc, other, upper);
        ge_add(acc, lo, hi);
    }
    if (part == 0 && lane < n) ge_tobytes4(out + 128 * (size_t)lane, acc);
}

extern "C" int ba_fixed_base(int n, const void* s_enc, const void* table, void* out, void* stream) {
    if (n <= 0) return 0;
    const long threads = 8L * n;
    fixed_base_kernel<<<(unsigned)((threads + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)s_enc, (const uint8_t*)table, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
