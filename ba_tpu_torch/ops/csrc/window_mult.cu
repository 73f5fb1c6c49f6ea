// K3': [k]P by 4-bit windows, one thread a lane; in fold mode the sum of
// the products over all lanes as well.
//
// Replaces ba_tpu/ops/ladder.py::_window_kernel (the Pallas TPU kernel,
// body _window_acc at :77, through window_mult at :256), which the batch
// verifier (ed25519.verify_rlc) runs for [z]R and [W]A, and in fold mode
// also the sum the reference leaves to XLA (ed25519.batch_point_sum).
// Per lane window_acc (window.cuh, the code K3 runs) over the nbytes of
// the little-endian k, 2 nbytes windows.  nbytes is a template parameter:
// K3' is built for the lengths its callers pass (K3P_LENGTHS: 1 for
// verify_rlc's cofactor 8, 16 for [z]R, 32 for [W]A and the ladder leg),
// so each instance runs a window loop of constant trip count, as K3
// does; the launchers refuse any other length.
//
// Fold: a block is one warp of 32 lanes (lanes past n hold the
// identity).  Five shuffle levels sum the block as a halving tree: lane
// t adds lane t + 16, then t + 8, ..., t + 1 (every lane computes; lane
// 0's sum is the block's), as batch_point_sum pairs 32 points.  Lane 0
// stores it in `partials`, fences, and counts the block in `done`; the
// block that counts last sums the partials: lane t adds partials t,
// t + 32, t + 64, ... in turn to the identity, then one more halving
// tree.  The pairing is fixed, so the plain version (ops/ladder.py
// fold_points) gives the same encodings.
//
// Bound: operations, per lane 14 x 9 multiplies for the table and per
// window 26 multiplies and 12 squarings: 958 and 384 at 32 windows (a
// 16-byte k), 1 790 and 768 at 64; a fold adds about one addition (9)
// a lane.  Bytes: 128 + nbytes in and 128 out a lane (128 in all with
// fold).  The point, the accumulator and the field temporaries stay in
// registers; the table in local memory, as in K3.
//
// Interface: point uint8 [n, 4, 32] (canonical X, Y, Z, T), k uint8
// [n, nbytes] -> out uint8 [n, 4, 32], or [1, 4, 32] with fold; fold
// scratch: partials int32 [ceil(n / 32), 40], done int32 [1] = 0.

#include <type_traits>

#include "window.cuh"

template <int NBYTES>
ED_FN void window_mult_lane(const uint8_t* pt, const uint8_t* k, ge& acc) {
    ge p;
    ge_frombytes4(p, pt);
    window_acc<NBYTES>(acc, p, k);
}

// Calls f(std::integral_constant<int, nbytes>{}) when K3' is built for
// nbytes, and returns whether it is.
template <class F>
inline bool with_k3p_length(int nbytes, F&& f) {
    switch (nbytes) {
        case 1: f(std::integral_constant<int, 1>{}); return true;
        case 16: f(std::integral_constant<int, 16>{}); return true;
        case 32: f(std::integral_constant<int, 32>{}); return true;
        default: return false;
    }
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

// The per-lane kernel (the ladder leg, K3's 64 windows alone) is built as
// K3 is: no spill.  With (32, 1) ptxas may take 255 registers and spills
// nothing; under (32) it settles at 168 and spills, which is faster where
// the lanes of a warp index the table with different digits and slower
// where they share them, as config #3's lanes do (scripts/k3p_variants.py).
template <int NBYTES>
__global__ void __launch_bounds__(32, 1) window_mult_kernel(int n, const uint8_t* __restrict__ pt,
                                                         const uint8_t* __restrict__ k,
                                                         uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    ge acc;
    window_mult_lane<NBYTES>(pt + 128 * (size_t)lane, k + (size_t)NBYTES * lane, acc);
    ge_tobytes4(out + 128 * (size_t)lane, acc);
}

template <int NBYTES>
__global__ void __launch_bounds__(32) window_mult_fold_kernel(int n,
                                                              const uint8_t* __restrict__ pt,
                                                              const uint8_t* __restrict__ k,
                                                              ge* partials, unsigned int* done,
                                                              uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    ge acc;
    if (lane < n)
        window_mult_lane<NBYTES>(pt + 128 * (size_t)lane, k + (size_t)NBYTES * lane, acc);
    else
        ge_identity(acc);
    warp_halving_sum(acc);
    __shared__ bool last;
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = acc;
        __threadfence();
        last = atomicAdd(done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    ge total;
    ge_identity(total);
#pragma unroll 1
    for (unsigned int row = 0; row * 32 < gridDim.x; row++) {
        const unsigned int idx = row * 32 + threadIdx.x;
        ge part;
        if (idx < gridDim.x) {
            const int32_t* src = &partials[idx].x.v[0];
            int32_t* dst = &part.x.v[0];
#pragma unroll
            for (int i = 0; i < 40; i++) dst[i] = __ldcg(src + i);  // past L1: other SMs wrote it
        } else {
            ge_identity(part);
        }
        ge_add(total, total, part);
    }
    warp_halving_sum(total);
    if (threadIdx.x == 0) ge_tobytes4(out, total);
}

// Both launchers return cudaErrorInvalidValue for a length K3' is not
// built for, else cudaGetLastError() after the launch.
extern "C" int ba_window_mult(int n, int nbytes, const void* pt, const void* k, void* out,
                              void* stream) {
    if (n <= 0) return 0;
    const bool built = with_k3p_length(nbytes, [&](auto nb) {
        window_mult_kernel<decltype(nb)::value><<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
            n, (const uint8_t*)pt, (const uint8_t*)k, (uint8_t*)out);
    });
    return built ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

extern "C" int ba_window_mult_fold(int n, int nbytes, const void* pt, const void* k,
                                   void* partials, void* done, void* out, void* stream) {
    if (n <= 0) return 0;
    const bool built = with_k3p_length(nbytes, [&](auto nb) {
        window_mult_fold_kernel<decltype(nb)::value>
            <<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
                n, (const uint8_t*)pt, (const uint8_t*)k, (ge*)partials, (unsigned int*)done,
                (uint8_t*)out);
    });
    return built ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

#endif
