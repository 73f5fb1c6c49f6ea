// K3': [k]P by signed 3-bit windows, one thread a lane; and the batch
// verifier's right side, [8](sum_i [z_i]R_i + sum_j [W_j]A_j), in one
// launch.
//
// Replaces ba_tpu/ops/ladder.py::_window_kernel (the Pallas TPU kernel,
// body _window_acc at :77, through window_mult at :256), which the batch
// verifier (ba_tpu/crypto/ed25519.py:389-395) runs for [z]R and [W]A
// before it sums each with batch_point_sum and doubles the sum of the two
// three times; here the sums and the doublings are in the kernel too.
// Per lane window_acc (window.cuh, the code K3 runs): its table in shared
// memory, lane-major, 20 kB a 32-lane block.  Two instances: the per-lane
// kernel for a 32-byte k (the ladder leg), which, as K3 does, runs a warp
// whose lanes hold one point on the warp's one 4-bit table; and the sum
// kernel, whose blocks run 32-byte lanes (the [W]A set) or 16-byte ones
// (the [z]R set), their points distinct.
//
// The sum kernel's grid runs the [W]A set's blocks first, then the [z]R
// set's: the block scheduler hands out blocks in index order, so the
// longest lanes start first and their chains overlap the short ones on
// the other SMs.  Each block (one warp; lanes past a set's end hold the
// identity) sums its lanes by a halving tree of five shuffle levels:
// lane t adds lane t + 16, then t + 8, ..., t + 1.  The G block sums are
// the leaves of a binary tree: at a level of s nodes, node 2i + 1 is
// added to node 2i and an odd last node passes up.  Each block climbs
// from its leaf; at a pair the block that counts second adds the two and
// climbs on, the first stops.  So after the last block's own sum the
// serial depth is ceil(log2 G) additions, and the other levels overlap
// the lanes still running.  The root, doubled three times, is the
// output.  The pairing is fixed, so the plain version (ops/ladder.py
// fold_points) gives the same encodings.
//
// Bound: operations.  Per lane 28 multiplies for the table and per
// window 21 multiplies and 9 squarings (window.cuh): 931 and 387 at 43
// windows (a 16-byte k), 1 834 and 774 at 86; a sum adds one addition
// (9 multiplies) a lane and three doublings.  The least work of the same
// product is signed 4-bit windows' (864 and 384, 1 664 and 768), which
// the bound counts.  Bytes: 128 + nbytes in a lane, 128 out a lane (128
// in all for the sum).
//
// Interface: point uint8 [n, 4, 32] (canonical X, Y, Z, T), k uint8
// [n, 32] -> out uint8 [n, 4, 32]; the sum: the [W]A set (na points,
// 32-byte k) and the [z]R set (nz points, 16-byte k) -> out uint8
// [1, 4, 32]; its scratch: nodes int32 [2 G, 40], counts int32 [G] = 0,
// G = ceil(na / 32) + ceil(nz / 32).

#include "window.cuh"

constexpr int K3P_LANES = 32;  // lanes a block: one warp, one column of the table each
constexpr int K3P_TABLE_WORDS = WindowTable<WINDOW_BITS>::WORDS;

// block_tab: the block's table, the lane's column at col, STRIDE words
// apart, or the warp's one table when warp_point (window.cuh).
template <int NBYTES, int STRIDE>
ED_FN void window_mult_lane(const uint8_t* pt, const uint8_t* k, int32_t* block_tab, int col,
                            bool warp_point, ge& acc) {
    ge p;
    ge_frombytes4(p, pt);
    window_acc_lane<NBYTES, STRIDE>(acc, p, k, block_tab, col, warp_point);
}

// v = [8]v by three doublings (T on the last), as the reference doubles
// the sum three times.
ED_FN void ge_times8(ge& v) {
    ge_dbl(v, v, false);
    ge_dbl(v, v, false);
    ge_dbl(v, v, true);
}

#if defined(__CUDACC__)

__device__ __forceinline__ void ge_shfl_down(ge& h, const ge& f, int offset) {
    const int32_t* src = &f.x.v[0];
    int32_t* dst = &h.x.v[0];
#pragma unroll
    for (int i = 0; i < 40; i++) dst[i] = __shfl_down_sync(0xffffffffu, src[i], offset);
}

// The warp's halving tree: lane 0 ends with the sum of the 32 lanes.
__device__ __forceinline__ void warp_halving_sum(ge& acc) {
#pragma unroll 1
    for (int offset = 16; offset > 0; offset >>= 1) {
        ge other;
        ge_shfl_down(other, acc, offset);
        ge_add(acc, acc, other);
    }
}

// One thread of each block: the block's sum v climbs the tree from leaf
// blockIdx.x.  nodes holds one slot a node of each level, counts one
// counter a pair.
__device__ void climb_and_finish(ge v, ge* nodes, unsigned int* counts, uint8_t* out) {
    unsigned int idx = blockIdx.x, size = gridDim.x, node_base = 0, count_base = 0;
    while (size > 1) {
        const unsigned int sib = idx ^ 1u;
        if (sib < size) {
            nodes[node_base + idx] = v;
            __threadfence();
            if (atomicAdd(&counts[count_base + (idx >> 1)], 1u) == 0) return;
            __threadfence();
            ge other;
            const int32_t* src = &nodes[node_base + sib].x.v[0];
            int32_t* dst = &other.x.v[0];
#pragma unroll
            for (int i = 0; i < 40; i++) dst[i] = __ldcg(src + i);  // past L1: another SM wrote it
            if (idx & 1u)
                ge_add(v, other, v);
            else
                ge_add(v, v, other);
        }
        node_base += size;
        count_base += size >> 1;
        idx >>= 1;
        size = (size + 1) >> 1;
    }
    ge_times8(v);
    ge_tobytes4(out, v);
}

// The per-lane kernel's two instances, both launched over every block a
// call, as K3's (window_verify.cu): WARP = false runs the blocks whose
// warp holds several points, WARP = true those whose warp holds one, each
// with the registers its own chain needs.  Bounds (32), no minimum of
// blocks: ptxas settled at 206 registers and no spill for the lanes'
// chain, 9 blocks a SM (its table's 20 kB a block allows 10); under
// (32, 1) it took 255 with 68 bytes of spill, 8 blocks, 1.3 % slower on
// an H100 (scripts/k3p_variants.py).  The warp's chain takes 255 with 80
// bytes of spill either way.
template <bool WARP>
__global__ void __launch_bounds__(K3P_LANES) window_mult_kernel(int n,
                                                                  const uint8_t* __restrict__ pt,
                                                                  const uint8_t* __restrict__ k,
                                                                  uint8_t* __restrict__ out) {
    __shared__ int32_t tab[WARP ? WARP_TABLE_WORDS : K3P_TABLE_WORDS * K3P_LANES];
    if (warp_one_point(pt, n) != WARP) return;
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ge acc;
    window_mult_lane<32, K3P_LANES>(pt + 128 * (size_t)lane, k + 32 * (size_t)lane, tab,
                                    threadIdx.x, WARP, acc);
    ge_tobytes4(out + 128 * (size_t)lane, acc);
}

// Both lanes' chains inlined: ptxas takes 255 registers with 148 bytes of
// spill whatever the bounds.  Calling them out of line (__noinline__, no
// spill, a 192-byte frame) ran 3.7 % slower on an H100.
__global__ void __launch_bounds__(K3P_LANES) window_mult_sum8_kernel(
    int na, const uint8_t* __restrict__ pa, const uint8_t* __restrict__ ka, int nz,
    const uint8_t* __restrict__ pz, const uint8_t* __restrict__ kz, ge* nodes,
    unsigned int* counts, uint8_t* __restrict__ out) {
    __shared__ int32_t tab[K3P_TABLE_WORDS * K3P_LANES];
    const int ga = (na + K3P_LANES - 1) / K3P_LANES;
    const bool in_a = (int)blockIdx.x < ga;
    const int lane = ((int)blockIdx.x - (in_a ? 0 : ga)) * K3P_LANES + threadIdx.x;
    ge acc;
    if (in_a && lane < na)
        window_mult_lane<32, K3P_LANES>(pa + 128 * (size_t)lane, ka + 32 * (size_t)lane, tab,
                                        threadIdx.x, false, acc);
    else if (!in_a && lane < nz)
        window_mult_lane<16, K3P_LANES>(pz + 128 * (size_t)lane, kz + 16 * (size_t)lane, tab,
                                        threadIdx.x, false, acc);
    else
        ge_identity(acc);
    warp_halving_sum(acc);
    if (threadIdx.x == 0) climb_and_finish(acc, nodes, counts, out);
}

// Both launchers return cudaGetLastError() after the launch.
extern "C" int ba_window_mult(int n, const void* pt, const void* k, void* out, void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + K3P_LANES - 1) / K3P_LANES;
    window_mult_kernel<false><<<blocks, K3P_LANES, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)pt, (const uint8_t*)k, (uint8_t*)out);
    window_mult_kernel<true><<<blocks, K3P_LANES, 0, (cudaStream_t)stream>>>(
        n, (const uint8_t*)pt, (const uint8_t*)k, (uint8_t*)out);
    return (int)cudaGetLastError();
}

extern "C" int ba_window_mult_sum8(int na, const void* pa, const void* ka, int nz,
                                   const void* pz, const void* kz, void* nodes, void* counts,
                                   void* out, void* stream) {
    const int blocks = (na + K3P_LANES - 1) / K3P_LANES + (nz + K3P_LANES - 1) / K3P_LANES;
    if (blocks <= 0) return (int)cudaErrorInvalidValue;
    window_mult_sum8_kernel<<<blocks, K3P_LANES, 0, (cudaStream_t)stream>>>(
        na, (const uint8_t*)pa, (const uint8_t*)ka, nz, (const uint8_t*)pz, (const uint8_t*)kz,
        (ge*)nodes, (unsigned int*)counts, (uint8_t*)out);
    return (int)cudaGetLastError();
}

#endif
