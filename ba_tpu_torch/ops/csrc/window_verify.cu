// K3: the verification tail, [h]A by signed 3-bit windows, R + [h]A, and
// the projective equality with [S]B; one thread a lane, one verdict a
// lane.
//
// Replaces ba_tpu/ops/ladder.py::_window_verify_kernel (the Pallas TPU
// kernel, body _window_acc at :77).  Per lane: [h]A by window_acc
// (window.cuh, shared with K3'), the carry digit and 86 windows of the
// little-endian h, or, where the warp's 32 lanes hold one A (the
// commander's key on every lieutenant's lane, as BASELINE config #3 lays
// them out), 64 windows of 4 bits on the warp's one table; then R + acc
// and X_l Z_r == X_r Z_l and Y_l Z_r ==
// Y_r Z_l.  A lane whose encodings were invalid gets a verdict all the
// same; the caller masks it (ed25519.verify does).
//
// Bound: operations, the least work of the product: 1 677 multiplies
// and 768 squarings a lane by signed 4-bit windows (64 for the table,
// 64 x (25 + 12) for the windows, 9 + 4 to finish); the 3-bit chain
// runs 1 847 and 774 (28, 86 x (21 + 9), 13).  The point, the
// accumulator and the field temporaries stay in registers, the table (4
// cached points, 640 B a lane) in shared memory, 20 kB a 32-lane block,
// laid out so that a warp reads it without bank conflicts whatever its
// digits.  Bytes: 416 in a lane (A, R, [S]B's X, Y, Z, h) and 1 out.
//
// Interface: a, r uint8 [n, 4, 32] (canonical X, Y, Z, T), h uint8
// [n, 32], left uint8 [n, 4, 32] (T unread) -> ok uint8 [n].

#include "window.cuh"

constexpr int K3_LANES = 32;  // lanes a block: one warp, one column of the table each

// block_tab: the block's table, the lane's column at col, STRIDE words
// apart, or the warp's one table when warp_point (window.cuh).
template <int STRIDE>
ED_FN bool window_verify_lane(const uint8_t* a_pt, const uint8_t* h, const uint8_t* r_pt,
                              const uint8_t* left, int32_t* block_tab, int col,
                              bool warp_point) {
    ge a, acc;
    ge_frombytes4(a, a_pt);
    window_acc_lane<32, STRIDE>(acc, a, h, block_tab, col, warp_point);
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

// Two instances, both launched over every block a call: WARP = false runs
// the blocks whose warp holds several points A (the lanes' own 3-bit
// tables), WARP = true those whose warp holds one (its one 4-bit table);
// each leaves the other's blocks at once.  Apart, the lanes' chain keeps
// the registers it needs: inlined in one kernel with the warp's chain it
// took 255 registers with spill, slower on both kinds of warp on an H100.
// Bounds (32), no minimum of blocks: ptxas settled at 186 registers and
// no spill for the lanes' chain, 10 blocks a SM, as its table's 20 kB a
// block allows (under (32, 1): 255 with 84 bytes of spill, 1.5 %
// slower); the warp's chain takes 255 with 92 bytes of spill either way.
template <bool WARP>
__global__ void __launch_bounds__(K3_LANES) window_verify_kernel(
    int n, const uint8_t* __restrict__ a, const uint8_t* __restrict__ h,
    const uint8_t* __restrict__ r, const uint8_t* __restrict__ left, uint8_t* __restrict__ ok) {
    __shared__ int32_t tab[WARP ? WARP_TABLE_WORDS : WindowTable<WINDOW_BITS>::WORDS * K3_LANES];
    if (warp_one_point(a, n) != WARP) return;
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t p = 128 * (size_t)lane;
    ok[lane] = window_verify_lane<K3_LANES>(a + p, h + 32 * (size_t)lane, r + p, left + p, tab,
                                            threadIdx.x, WARP) ? 1 : 0;
}

extern "C" int ba_window_verify(int n, const void* a, const void* h, const void* r,
                                const void* left, void* ok, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + K3_LANES - 1) / K3_LANES;
    window_verify_kernel<false><<<blocks, K3_LANES, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (const uint8_t*)h, (const uint8_t*)r, (const uint8_t*)left,
        (uint8_t*)ok);
    window_verify_kernel<true><<<blocks, K3_LANES, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)a, (const uint8_t*)h, (const uint8_t*)r, (const uint8_t*)left,
        (uint8_t*)ok);
    return (int)cudaGetLastError();
}

#endif
