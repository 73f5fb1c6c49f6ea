// K3: the verification tail, [h]A by 4-bit windows, R + [h]A, and the
// projective equality with [S]B; one thread a lane, one verdict a lane.
//
// Replaces ba_tpu/ops/ladder.py::_window_verify_kernel (the Pallas TPU
// kernel, body _window_acc at :77).  Per lane: [h]A by window_acc
// (window.cuh, shared with K3'), 64 windows of the little-endian h; then
// R + acc and X_l Z_r == X_r Z_l and Y_l Z_r == Y_r Z_l.  A lane
// whose encodings were invalid gets a verdict all the same; the caller
// masks it (ed25519.verify does).
//
// Bound: operations, 2 571 field products a lane (14 x 9 for the table,
// 64 x (3 x 7 + 8 + 9) for the windows, 9 + 4 to finish), 768 of them
// squarings (3 a doubling).  The
// point, the accumulator and the field temporaries stay in registers;
// the table (16 points, 2.5 kB a lane) is indexed by the digit, so it
// lives in local memory, which L1 holds at these lane counts.  Bytes:
// 416 in a lane (A, R, [S]B's X, Y, Z, h) and 1 out.
//
// Interface: a, r uint8 [n, 4, 32] (canonical X, Y, Z, T), h uint8
// [n, 32], left uint8 [n, 4, 32] (T unread) -> ok uint8 [n].

#include "window.cuh"

ED_FN bool window_verify_lane(const uint8_t* a_pt, const uint8_t* h, const uint8_t* r_pt,
                              const uint8_t* left) {
    ge a, acc;
    ge_frombytes4(a, a_pt);
    window_acc<32>(acc, a, h);
    ge r;
    ge_frombytes4(r, r_pt);
    ge_add(r, r, acc);
    fe xl, yl, zl, s1, s2;
    fe_frombytes(xl, left);
    fe_frombytes(yl, left + 32);
    fe_frombytes(zl, left + 64);
    fe_mul(s1, xl, r.z);
    fe_mul(s2, r.x, zl);
    const bool ok_x = fe_eq(s1, s2);
    fe_mul(s1, yl, r.z);
    fe_mul(s2, r.y, zl);
    return ok_x && fe_eq(s1, s2);
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(32) window_verify_kernel(int n, const uint8_t* __restrict__ a,
                                                           const uint8_t* __restrict__ h,
                                                           const uint8_t* __restrict__ r,
                                                           const uint8_t* __restrict__ left,
                                                           uint8_t* __restrict__ ok) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t p = 128 * (size_t)lane;
    ok[lane] = window_verify_lane(a + p, h + 32 * (size_t)lane, r + p, left + p) ? 1 : 0;
}

extern "C" int ba_window_verify(int n, const void* a, const void* h, const void* r,
                                const void* left, void* ok, void* stream) {
    if (n <= 0) return 0;
    window_verify_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (const uint8_t*)h, (const uint8_t*)r, (const uint8_t*)left,
        (uint8_t*)ok);
    return (int)cudaGetLastError();
}

#endif
