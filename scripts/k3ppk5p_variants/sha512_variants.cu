// K5''s designs beside the shipped one (ba_tpu_torch/ops/csrc/sha512_modl.cu),
// for scripts/k3ppk5p_variants.py: a variant number a launch of
// ba_sha512_variant, each output held bit-equal to the shipped kernel's.
//
//   0  v13: the previous design: one thread a lane, 128-thread blocks, the
//      80 rounds with the message schedule in a 16-word ring of registers
//      on the same thread.
//   2  b64: the shipped lane at 64-thread blocks (shipped: 32; v13: 128).
//   3  sched: two warps a 32-lane group, 64-thread blocks: warp 0 runs the
//      80 rounds, warp 1 the message schedule; W16..W79 cross in shared
//      memory (lane-major, 20 kB a group), the schedule warp arriving at
//      named barrier 1 + j once W16(j+1)..W16(j+1)+15 are stored and the
//      round warp waiting on it before round 16(j + 1); barrier 5 holds the
//      schedule warp from a block's words until the rounds have read the
//      previous block's.
//
// The probes, never launched, split one compression block's SASS count
// (chip_smoke.SHA_BLOCK_OPS) in two: sha512_schedule_probe loads a block's
// 16 words, computes W16..W79 and stores them; sha512_rounds_probe loads
// the state and the 80 words, runs the 80 rounds and the feed-forward, and
// stores the state.
//
// Interface: wh, wl int64 [n, n_blocks, 16] -> out uint8 [n, 64].

#include "sha512_modl.cu"

ED_FN void v13_sha512_block(uint64_t st[8], uint64_t w[16]) {
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        if (t >= 16) {
            const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        const uint64_t ch = (e & f) ^ (~e & g);
        const uint64_t t1 = h + S1 + ch + SHA512_K[t] + w[t & 15];
        const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

ED_FN void v13_sha512_lane(const int64_t* wh, const int64_t* wl, int n_blocks, modl_vec* out) {
    uint64_t st[8];
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = SHA512_H0[i];
#pragma unroll 1
    for (int blk = 0; blk < n_blocks; blk++) {
        const sha512_halves* h = (const sha512_halves*)(wh + 16 * blk);
        const sha512_halves* l = (const sha512_halves*)(wl + 16 * blk);
        uint64_t w[16];
#pragma unroll
        for (int k = 0; k < 8; k++) {
            const sha512_halves a = h[k], b = l[k];
            w[2 * k] = ((uint64_t)a.x << 32) | ((uint64_t)b.x & 0xffffffffULL);
            w[2 * k + 1] = ((uint64_t)a.y << 32) | ((uint64_t)b.y & 0xffffffffULL);
        }
        v13_sha512_block(st, w);
    }
#pragma unroll
    for (int k = 0; k < 4; k++)
        out[k] = modl_vec{sha512_bswap32((uint32_t)(st[2 * k] >> 32)),
                          sha512_bswap32((uint32_t)st[2 * k]),
                          sha512_bswap32((uint32_t)(st[2 * k + 1] >> 32)),
                          sha512_bswap32((uint32_t)st[2 * k + 1])};
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) v13_sha512_kernel(int n, int n_blocks,
                                                         const int64_t* __restrict__ wh,
                                                         const int64_t* __restrict__ wl,
                                                         modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    v13_sha512_lane(wh + off, wl + off, n_blocks, out + 4 * (size_t)lane);
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) block_kernel(int n, int n_blocks,
                                                        const int64_t* __restrict__ wh,
                                                        const int64_t* __restrict__ wl,
                                                        modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    v13_sha512_lane(wh + off, wl + off, n_blocks, out + 4 * (size_t)lane);
}

ED_FN void sched_round(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t& e,
                       uint64_t& f, uint64_t& g, uint64_t& h, uint64_t kw) {
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + S1 + ch + kw;
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + mj;
}

ED_FN void sched_load(uint64_t w[16], const int64_t* wh, const int64_t* wl) {
    const sha512_halves* h = (const sha512_halves*)wh;
    const sha512_halves* l = (const sha512_halves*)wl;
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const sha512_halves a = h[k], b = l[k];
        w[2 * k] = ((uint64_t)a.x << 32) | ((uint64_t)b.x & 0xffffffffULL);
        w[2 * k + 1] = ((uint64_t)a.y << 32) | ((uint64_t)b.y & 0xffffffffULL);
    }
}

__global__ void __launch_bounds__(64) sched_kernel(int n, int n_blocks,
                                                   const int64_t* __restrict__ wh,
                                                   const int64_t* __restrict__ wl,
                                                   modl_vec* __restrict__ out) {
    __shared__ uint64_t W[64][32];  // W16..W79 of the group's 32 lanes
    const int warp = threadIdx.x >> 5, col = threadIdx.x & 31;
    const int lane = blockIdx.x * 32 + col;
    if (lane - col >= n) return;
    const size_t off = (size_t)(lane < n ? lane : n - 1) * n_blocks * 16;
    if (warp == 1) {
#pragma unroll 1
        for (int blk = 0; blk < n_blocks; blk++) {
            if (blk > 0) asm volatile("bar.sync 5, 64;" ::: "memory");
            uint64_t w[16];
            sched_load(w, wh + off + 16 * blk, wl + off + 16 * blk);
#pragma unroll
            for (int t = 16; t < 80; t++) {
                const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
                const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
                w[t & 15] += s0 + w[(t - 7) & 15] + s1;
                W[t - 16][col] = w[t & 15];
                if ((t & 15) == 15) asm volatile("bar.arrive %0, 64;" ::"r"(t >> 4) : "memory");
            }
        }
        return;
    }
    uint64_t st[8];
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = SHA512_H0[i];
#pragma unroll 1
    for (int blk = 0; blk < n_blocks; blk++) {
        uint64_t w[16];
        sched_load(w, wh + off + 16 * blk, wl + off + 16 * blk);
        uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
        uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
        for (int t = 0; t < 80; t++) {
            if (t >= 16 && (t & 15) == 0) asm volatile("bar.sync %0, 64;" ::"r"(t >> 4) : "memory");
            sched_round(a, b, c, d, e, f, g, h, SHA512_K[t] + (t < 16 ? w[t] : W[t - 16][col]));
        }
        st[0] += a; st[1] += b; st[2] += c; st[3] += d;
        st[4] += e; st[5] += f; st[6] += g; st[7] += h;
        if (blk + 1 < n_blocks) asm volatile("bar.arrive 5, 64;" ::: "memory");
    }
    if (lane >= n) return;
#pragma unroll
    for (int k = 0; k < 4; k++)
        out[4 * (size_t)lane + k] = modl_vec{sha512_bswap32((uint32_t)(st[2 * k] >> 32)),
                                             sha512_bswap32((uint32_t)st[2 * k]),
                                             sha512_bswap32((uint32_t)(st[2 * k + 1] >> 32)),
                                             sha512_bswap32((uint32_t)st[2 * k + 1])};
}

__global__ void sha512_schedule_probe(const ulonglong2* __restrict__ in,
                                      ulonglong2* __restrict__ out) {
    const size_t lane = blockIdx.x * blockDim.x + threadIdx.x;
    uint64_t w[80];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const ulonglong2 a = in[8 * lane + k];
        w[2 * k] = a.x;
        w[2 * k + 1] = a.y;
    }
#pragma unroll
    for (int t = 16; t < 80; t++) {
        const uint64_t w15 = w[t - 15], w2 = w[t - 2];
        const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
        const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
#pragma unroll
    for (int k = 8; k < 40; k++) out[32 * lane + k - 8] = ulonglong2{w[2 * k], w[2 * k + 1]};
}

__global__ void sha512_rounds_probe(const ulonglong2* __restrict__ in,
                                    ulonglong2* __restrict__ out) {
    const size_t lane = blockIdx.x * blockDim.x + threadIdx.x;
    uint64_t st[8], w[80];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const ulonglong2 a = in[44 * lane + k];
        st[2 * k] = a.x;
        st[2 * k + 1] = a.y;
    }
#pragma unroll
    for (int k = 0; k < 40; k++) {
        const ulonglong2 a = in[44 * lane + 4 + k];
        w[2 * k] = a.x;
        w[2 * k + 1] = a.y;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        const uint64_t ch = (e & f) ^ (~e & g);
        const uint64_t t1 = h + S1 + ch + SHA512_K[t] + w[t];
        const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        const uint64_t mj = (a & b) ^ (a & c) ^ (b & c);
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + S0 + mj;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
#pragma unroll
    for (int k = 0; k < 4; k++) out[4 * lane + k] = ulonglong2{st[2 * k], st[2 * k + 1]};
}

extern "C" int ba_sha512_variant(int variant, int n, int n_blocks, const void* wh,
                                 const void* wl, void* out, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const int64_t* h = (const int64_t*)wh;
    const int64_t* l = (const int64_t*)wl;
    modl_vec* o = (modl_vec*)out;
    switch (variant) {
        case 0:
            v13_sha512_kernel<<<(n + 127) / 128, 128, 0, s>>>(n, n_blocks, h, l, o);
            break;
        case 2:
            block_kernel<64><<<(n + 63) / 64, 64, 0, s>>>(n, n_blocks, h, l, o);
            break;
        case 3:
            sched_kernel<<<(n + 31) / 32, 64, 0, s>>>(n, n_blocks, h, l, o);
            break;
        default:
            return -1;
    }
    return (int)cudaGetLastError();
}

#endif
