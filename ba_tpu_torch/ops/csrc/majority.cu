// K9: the masked strict majority with a fallback, one row a thread or one
// row a warp.
//
// Replaces ba_tpu/ops/majority.py::_majority_kernel (the Pallas TPU kernel,
// through masked_majority_rows): for each row, count ATTACK (1) and RETREAT
// (0) answers over the valid responders and emit ATTACK or RETREAT by strict
// majority, UNDEFINED (2) on a tie, and the row's fallback when no responder
// is valid.  Every EIG resolve level is one launch (core/eig.py::_resolve_from).
//
// Bound: bytes.  A row reads K answer bytes, K mask bytes (or its share of a
// mask row that S receivers share) and a fallback byte, and writes one byte;
// the arithmetic is a few integer operations a byte.  The design reads each
// byte once: a row of K <= 32 is one thread's (byte loads, so a warp covers
// 32 neighbouring rows: ~32 K contiguous bytes an instruction), a longer row
// is one warp's (lane l takes words l, l + 32, ...: 128 contiguous bytes an
// instruction), summed by shuffles.  Where K is a multiple of 4 and both
// bases are 4-byte aligned, four bytes are tallied at a time (SWAR).
//
// Layout: answers int8 [G, S, P, K] (R = G S P rows), valid bool [G, P, K]
// (row (g, s, p) reads mask row (g, p): S = 1 and P = R is the dense [R, K]
// form), fallback int8 [R] -> out int8 [R].
//
// The tally functions compile as host C++ too (MAJ_FN is `static inline`
// without nvcc), so tests/torch_csrc_host.cpp replays the lanes off the card.

#include <stdint.h>

#if defined(__CUDACC__)
#define MAJ_FN __host__ __device__ __forceinline__
#else
#define MAJ_FN static inline
#endif

struct Tally {
    int att, ret, elig;
};

MAJ_FN int popc32(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no carry
// crosses a byte, Hacker's Delight 6-1).
MAJ_FN uint32_t zero_bytes(uint32_t x) {
    const uint32_t y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
    return ~(y | x | 0x7F7F7F7Fu);
}

// Four answers and four mask bytes (any non-zero mask byte is valid).
MAJ_FN void tally_word(uint32_t a, uint32_t v, Tally& t) {
    const uint32_t valid = ~zero_bytes(v) & 0x80808080u;
    t.att += popc32(zero_bytes(a ^ 0x01010101u) & valid);
    t.ret += popc32(zero_bytes(a) & valid);
    t.elig += popc32(valid);
}

MAJ_FN void tally_byte(uint8_t a, uint8_t v, Tally& t) {
    if (v) {
        t.att += a == 1;
        t.ret += a == 0;
        t.elig += 1;
    }
}

// Lane `lane` of `lanes` on one row: words lane, lane + lanes, ... when
// `words`, else bytes.
MAJ_FN Tally tally_lane(const uint8_t* a, const uint8_t* v, int K, bool words, int lane,
                        int lanes) {
    Tally t = {0, 0, 0};
    if (words) {
        const uint32_t* aw = (const uint32_t*)a;
        const uint32_t* vw = (const uint32_t*)v;
        for (int w = lane; w < K / 4; w += lanes) tally_word(aw[w], vw[w], t);
    } else {
        for (int k = lane; k < K; k += lanes) tally_byte(a[k], v[k], t);
    }
    return t;
}

MAJ_FN int8_t majority_of(Tally t, int8_t fallback) {
    if (t.elig == 0) return fallback;
    return t.att > t.ret ? 1 : (t.ret > t.att ? 0 : 2);
}

// The mask row that answer row r reads.
MAJ_FN int64_t mask_row(int64_t r, int64_t S, int64_t P) {
    return (r / (S * P)) * P + r % P;
}

#if defined(__CUDACC__)

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) majority_row_kernel(
    int64_t R, int K, int64_t S, int64_t P, bool words, const uint8_t* __restrict__ answers,
    const uint8_t* __restrict__ valid, const int8_t* __restrict__ fallback,
    int8_t* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (r >= R) return;
    const Tally t = tally_lane(answers + r * K, valid + mask_row(r, S, P) * K, K, words, 0, 1);
    out[r] = majority_of(t, fallback[r]);
}

__global__ void __launch_bounds__(THREADS) majority_warp_kernel(
    int64_t R, int K, int64_t S, int64_t P, bool words, const uint8_t* __restrict__ answers,
    const uint8_t* __restrict__ valid, const int8_t* __restrict__ fallback,
    int8_t* __restrict__ out) {
    const int64_t r = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
    if (r >= R) return;  // whole warps leave together: r is the warp's
    const int lane = threadIdx.x % 32;
    Tally t = tally_lane(answers + r * K, valid + mask_row(r, S, P) * K, K, words, lane, 32);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        t.att += __shfl_xor_sync(0xFFFFFFFFu, t.att, off);
        t.ret += __shfl_xor_sync(0xFFFFFFFFu, t.ret, off);
        t.elig += __shfl_xor_sync(0xFFFFFFFFu, t.elig, off);
    }
    if (lane == 0) out[r] = majority_of(t, fallback[r]);
}

// Rows of fewer than WARP_MIN_K answers are a thread's, longer rows a warp's.
constexpr int WARP_MIN_K = 33;

extern "C" int ba_majority(long long R, int K, long long S, long long P, const void* answers,
                           const void* valid, const void* fallback, void* out, void* stream) {
    if (R <= 0) return 0;
    const bool words = K % 4 == 0 && ((uintptr_t)answers % 4 == 0) && ((uintptr_t)valid % 4 == 0);
    const auto* a = (const uint8_t*)answers;
    const auto* v = (const uint8_t*)valid;
    const auto* f = (const int8_t*)fallback;
    auto* o = (int8_t*)out;
    if (K < WARP_MIN_K) {
        const long long blocks = (R + THREADS - 1) / THREADS;
        majority_row_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            R, K, S, P, words, a, v, f, o);
    } else {
        const long long blocks = (R + THREADS / 32 - 1) / (THREADS / 32);
        majority_warp_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            R, K, S, P, words, a, v, f, o);
    }
    return (int)cudaGetLastError();
}

#endif
