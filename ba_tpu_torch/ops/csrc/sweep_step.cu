// K2: the fused signed-sweep step for Hopper (sm_90a).
//
// Replaces ba_tpu/ops/sweep_step.py::_step_kernel, the Pallas TPU kernel
// of the signed sweep (BASELINE config #5): `rounds` whole signed,
// collapsed SM(m) agreement rounds per launch, for B independent
// instances of up to 1024 generals.  Per round and instance:
//   1. round 1: an honest leader sends its order; a faulty one a coin per
//      recipient; the leader keeps its order;
//   2. the signature gate: a general's value enters its V-set only if the
//      commander's table signature for that value verified (ok[b, v]);
//   3. m collapsed relay rounds: value v reaches every alive general when
//      an honest alive general holds it; otherwise with probability
//      P(u8 < T), T = 256 - 256 >> k for k alive traitor holders (256 for
//      k > 8), and only while r < t (t = alive traitors, a faulty leader
//      included: the chain bound);
//   4. choice (one value -> it, else UNDEFINED; the leader reports its
//      order), the counts over alive generals and the 3f+1 quorum.
//
// What bounds it: the instruction rate on each round's scalar work and the
// latency of its chain of reductions, not the mask operations the bound
// counts.  A round is a few dozen integer operations a 32-general mask
// word, but
// each relay round waits on a sum over the instance's lanes before it can
// compute its thresholds, the choice waits on one more, and every lane of
// an instance executes the same scalar work (sums, thresholds, quorum).  A
// design of one warp an instance, three collectives a relay round and
// thresholds by branches ran ~2 850 SM cycles a round a warp on an H100
// whatever n (chip_smoke.py's K2 line).
//
// What the design does about it:
// - one reduction a relay round instead of three: a lane packs its
//   capped traitor counts and honest flags of both values into one word
//   (sweep_relay.cuh) and one add over the instance's lanes sums all four;
// - thresholds by selects from that sum, no branches;
// - the round's scalar work (the sums, the thresholds, the quorum) is paid
//   once a warp whatever its instances, so a warp carries several: a lane
//   holds W = LANE_WORDS mask words (W 32 generals; one word at n <= 32)
//   and an instance takes a segment of S lanes, S the least power of two
//   with 32 W S >= n (S = 16 at n = 1024, 8 at n = 512, 1 at n <= 64), so
//   32 / S instances share a warp and every bit of their masks is a
//   general; a segment sums by log2 S xor shuffles; bit i of word w of
//   lane L is general L + S (32 w + i);
// - four rounds of the same instance a pass (ROUNDS_A_PASS): their
//   sums are independent, so one's latency hides the others'.  Every
//   round's relay, choice and quorum is computed; no decision is copied
//   from one round to another.
// - the draws sit out of line (round1_coins, relay_draws), so no part of
//   their work is hoisted into the rounds where no draw matters.
// LANE_WORDS = 2 and ROUNDS_A_PASS = 4 ran fastest on the signed sweep's
// buckets on an H100 (1 or 4 words, 1, 2, 3 or 8 rounds were slower:
// scripts/torch_checkout_ab.py --phase sweeps).
// The masks (alive, honest, traitor), t, the quorum size and the leader's
// bit are round-invariant and made once; the block never synchronises and
// uses no shared memory.  The TPU kernel's [TILE, n] planes in VMEM and
// its row reductions become these registers and segment reductions.
//
// Randomness: Philox4x32-10, written out here and in the plain version
// (ba_tpu_torch/ops/sweep_step.py) so the two are bit-equal; no library
// generator.  Key (seed, index_base + b), counter (rr, j, d / 4, 0), draw d = word
// d % 4: d = 0 the round-1 coin (bit 0), d = r relay round r (byte 0 for
// RETREAT, byte 1 for ATTACK).  index_base is the global index of the
// launch's first instance: a shard of a larger batch draws the streams the
// whole batch's launch would.  A draw is computed only where its value
// can matter: alive non-leader recipients of a faulty leader, and alive
// generals in a relay round whose threshold lies strictly inside (0, 256).
//
// Bound: operations.  Per instance-round a few dozen integer operations
// a 32-general mask word per relay round, plus one Philox call (40 32-bit
// multiplies, 80 operations) for each draw that matters; the state (2
// bytes a general) is read once and one byte a round written.  On the
// signed sweep with honest leaders and valid tables no draw matters.

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep_relay.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int ROUNDS_A_PASS = 4;
constexpr int LANE_WORDS = 2;  // 32-general mask words a lane, at n > 32
constexpr int MAX_N = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// Philox4x32-10: the counter c[0..3] becomes the four output words, key
// (k0, k1).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        if (i) {
            k0 += PHILOX_W0;
            k1 += PHILOX_W1;
        }
        const uint32_t lo0 = PHILOX_M0 * c[0], hi0 = __umulhi(PHILOX_M0, c[0]);
        const uint32_t lo1 = PHILOX_M1 * c[2], hi1 = __umulhi(PHILOX_M1, c[2]);
        c[0] = hi1 ^ c[1] ^ k0;
        c[1] = lo1;
        c[2] = hi0 ^ c[3] ^ k1;
        c[3] = lo0;
    }
}

// Word d % 4 of Philox4x32-10 at counter (c0, c1, d / 4, 0), key (k0, k1).
__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1, int d,
                                                uint32_t k0, uint32_t k1) {
    uint32_t c[4] = {c0, c1, (uint32_t)(d >> 2), 0u};
    philox4x32_10(c, k0, k1);
    switch (d & 3) {
        case 0: return c[0];
        case 1: return c[1];
        case 2: return c[2];
        default: return c[3];
    }
}

// One Philox block a thread, for the known-answer check of the generator
// the sweep kernel draws from: in[i] = (c0, c1, c2, c3, k0, k1), out[i] =
// the four words.
__global__ void philox_kernel(int count, const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= count) return;
    uint32_t c[4] = {in[6 * i], in[6 * i + 1], in[6 * i + 2], in[6 * i + 3]};
    philox4x32_10(c, in[6 * i + 4], in[6 * i + 5]);
    for (int w = 0; w < 4; ++w) out[4 * i + w] = c[w];
}

// The sum of v over the S lanes of a segment (S a power of two) by an xor
// butterfly.  (__reduce_add_sync with the segment's mask gave the same sums
// on an H100 but ran the signed sweep's step 1.6x slower.)
template <int S>
__device__ __forceinline__ uint32_t seg_sum(uint32_t v) {
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// The draws, out of line so that none of their work is hoisted into the
// rounds where no draw matters (the signed sweep's every round).  Bit i
// of `todo` is general j0 + step i.
// Round 1: a faulty leader's coins (bit 0 of draw 0).
__device__ __noinline__ uint32_t round1_coins(uint32_t todo, int rr, int j0, int step,
                                              uint32_t seed, uint32_t kb) {
    uint32_t coins = 0u;
    for (; todo; todo &= todo - 1) {
        const int i = __ffs(todo) - 1;
        coins |= (philox_word(rr, j0 + step * i, 0, seed, kb) & 1u) << i;
    }
    return coins;
}

// Relay round r: the generals each value reaches by draw (byte 0 below
// th_r for RETREAT, byte 1 below th_a for ATTACK; a threshold of 0 or 256
// draws nothing).
__device__ __noinline__ uint2 relay_draws(uint32_t todo, int rr, int j0, int step, int r,
                                          uint32_t seed, uint32_t kb, int th_r, int th_a) {
    const bool draw_r = th_r > 0 && th_r < 256;
    const bool draw_a = th_a > 0 && th_a < 256;
    uint2 fire = make_uint2(0u, 0u);
    for (; todo; todo &= todo - 1) {
        const int i = __ffs(todo) - 1;
        const uint32_t x = philox_word(rr, j0 + step * i, r, seed, kb);
        if (draw_r && (int)(x & 0xFFu) < th_r) fire.x |= 1u << i;
        if (draw_a && (int)((x >> 8) & 0xFFu) < th_a) fire.y |= 1u << i;
    }
    return fire;
}

template <int S, int W>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sweep_step_kernel(int B, int n, int m, int rounds, int index_base,
                  const int32_t* __restrict__ seed_p,
                  const int8_t* __restrict__ order, const int32_t* __restrict__ leader,
                  const uint8_t* __restrict__ faulty, const uint8_t* __restrict__ alive,
                  const uint8_t* __restrict__ ok, int8_t* __restrict__ dec) {
    constexpr int PER_WARP = 32 / S;  // instances a warp
    const int lane = threadIdx.x & 31;
    const int sl = lane & (S - 1);  // the lane in its segment
    const int b0 = (blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5)) * PER_WARP;
    if (b0 >= B) return;  // warp-uniform: whole warps leave
    const int b = b0 + lane / S;
    const bool valid = b < B;  // a lane past B keeps empty masks
    const uint32_t seed = (uint32_t)seed_p[0];
    const uint32_t kb = (uint32_t)index_base + (uint32_t)b;  // the Philox key's instance word
    const size_t row = (size_t)b * n;

    // Bit i of word w is general sl + S (32 w + i).
    uint32_t alive_m[W], honest_m[W], traitor_m[W], leader_bit[W];
    const int ord = valid ? order[b] : 0;
    const int ldr = valid ? leader[b] : -1;
    const bool ldr_ok = ldr >= 0 && ldr < n;
    const bool leader_faulty = ldr_ok && faulty[row + ldr] != 0;
    int n_traitor = 0, n_alive = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t al = 0u, fa = 0u;
        if (valid) {
            for (int i = 0; i < 32; ++i) {
                const int j = sl + S * (32 * w + i);
                if (j < n) {
                    al |= (uint32_t)(alive[row + j] != 0) << i;
                    fa |= (uint32_t)(faulty[row + j] != 0) << i;
                }
            }
        }
        alive_m[w] = al;
        honest_m[w] = al & ~fa;
        traitor_m[w] = al & fa;
        leader_bit[w] = (ldr_ok && (ldr & (S - 1)) == sl && (ldr / S) / 32 == w)
                            ? 1u << ((ldr / S) & 31) : 0u;
        n_traitor += __popc(traitor_m[w]);
        n_alive += __popc(al);
    }
    const uint32_t ord_a = ord == 1 ? FULL : 0u;  // the leader's own value, as masks
    const uint32_t ord_r = ord == 0 ? FULL : 0u;
    const uint32_t ok_r = valid && ok[2 * b] ? FULL : 0u;
    const uint32_t ok_a = valid && ok[2 * b + 1] ? FULL : 0u;

    const int t = (int)seg_sum<S>(n_traitor);
    const int total = (int)seg_sum<S>(n_alive);
    int needed = total >= 1 ? 2 * ((total - 1) / 3) + 1 : 0;
    if (total <= 3) needed = total - 1;
    if (total == 1) needed = 1;

    for (int rr = 0; rr < rounds; rr += ROUNDS_A_PASS) {
        // Round 1 and the signature gate of each round of the pass.
        uint32_t seen_r[ROUNDS_A_PASS][W], seen_a[ROUNDS_A_PASS][W];
#pragma unroll
        for (int h = 0; h < ROUNDS_A_PASS; ++h) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
                uint32_t recv_a = ord_a, recv_r = ord_r;
                if (leader_faulty) {
                    recv_a = round1_coins(alive_m[w] & ~leader_bit[w], rr + h, sl + 32 * S * w,
                                          S, seed, kb);
                    recv_r = ~recv_a;
                }
                recv_a = (recv_a & ~leader_bit[w]) | (ord_a & leader_bit[w]);
                recv_r = (recv_r & ~leader_bit[w]) | (ord_r & leader_bit[w]);
                seen_r[h][w] = recv_r & alive_m[w] & ok_r;
                seen_a[h][w] = recv_a & alive_m[w] & ok_a;
            }
        }

        // m collapsed relay rounds, one segment sum each.
        for (int r = 1; r <= m; ++r) {
            uint32_t sum[ROUNDS_A_PASS];
#pragma unroll
            for (int h = 0; h < ROUNDS_A_PASS; ++h) {
                int k_r = 0, k_a = 0;
                uint32_t held_r = 0u, held_a = 0u;
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    k_r += __popc(seen_r[h][w] & traitor_m[w]);
                    k_a += __popc(seen_a[h][w] & traitor_m[w]);
                    held_r |= seen_r[h][w] & honest_m[w];
                    held_a |= seen_a[h][w] & honest_m[w];
                }
                sum[h] = seg_sum<S>(relay_word(k_r, k_a, held_r != 0u, held_a != 0u));
            }
#pragma unroll
            for (int h = 0; h < ROUNDS_A_PASS; ++h) {
                const int th_r = relay_threshold(sum[h], 0, r < t);
                const int th_a = relay_threshold(sum[h], 1, r < t);
                const bool draws = (th_r > 0 && th_r < 256) || (th_a > 0 && th_a < 256);
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    uint32_t fire_r = th_r >= 256 ? alive_m[w] : 0u;
                    uint32_t fire_a = th_a >= 256 ? alive_m[w] : 0u;
                    if (draws) {
                        const uint2 f = relay_draws(alive_m[w], rr + h, sl + 32 * S * w, S, r,
                                                    seed, kb, th_r, th_a);
                        fire_r |= f.x;
                        fire_a |= f.y;
                    }
                    seen_r[h][w] = (seen_r[h][w] | fire_r) & alive_m[w];
                    seen_a[h][w] = (seen_a[h][w] | fire_a) & alive_m[w];
                }
            }
        }

        // choice(V), the counts over alive generals, the quorum.
        uint32_t cnt[ROUNDS_A_PASS];
#pragma unroll
        for (int h = 0; h < ROUNDS_A_PASS; ++h) {
            int c_a = 0, c_r = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
                const uint32_t lb = leader_bit[w];
                const uint32_t maj_a = (seen_a[h][w] & ~seen_r[h][w] & ~lb) | (ord_a & lb);
                const uint32_t maj_r = (seen_r[h][w] & ~seen_a[h][w] & ~lb) | (ord_r & lb);
                c_a += __popc(maj_a & alive_m[w]);
                c_r += __popc(maj_r & alive_m[w]);
            }
            cnt[h] = seg_sum<S>(c_a | (c_r << 16));
        }
        if (valid && sl == 0) {
#pragma unroll
            for (int h = 0; h < ROUNDS_A_PASS; ++h) {
                if (rr + h >= rounds) break;
                const int n_a = cnt[h] & 0xFFFF, n_r = cnt[h] >> 16;
                int8_t d = 2;  // UNDEFINED
                if (total > 0) d = needed <= n_r ? 0 : (needed <= n_a ? 1 : 2);
                dec[(size_t)b * rounds + rr + h] = d;
            }
        }
    }
}

// The layout for n generals: W = the least power of two up to LANE_WORDS
// with 32 W >= n (or LANE_WORDS), then S = the least power of two with
// 32 W S >= n.
void lane_layout(int n, int& S, int& W) {
    W = 1;
    while (W < LANE_WORDS && 32 * W < n) W <<= 1;
    S = 1;
    while (32 * W * S < n) S <<= 1;
}

template <int S, int W>
cudaError_t launch_sweep_step(int B, int n, int m, int rounds, int index_base, const void* seed,
                              const void* order, const void* leader, const void* faulty,
                              const void* alive, const void* ok, void* dec, cudaStream_t s) {
    constexpr int per_block = WARPS_PER_BLOCK * (32 / S);
    const dim3 grid((unsigned)((B + per_block - 1) / per_block));
    sweep_step_kernel<S, W><<<grid, WARPS_PER_BLOCK * 32, 0, s>>>(
        B, n, m, rounds, index_base, (const int32_t*)seed, (const int8_t*)order,
        (const int32_t*)leader,
        (const uint8_t*)faulty, (const uint8_t*)alive, (const uint8_t*)ok, (int8_t*)dec);
    return cudaGetLastError();
}

// The instance of W words a lane for S lanes an instance (32 W S <= 1024).
template <int W>
cudaError_t launch_words(int S, int B, int n, int m, int rounds, int index_base, const void* seed,
                         const void* order, const void* leader, const void* faulty,
                         const void* alive, const void* ok, void* dec, cudaStream_t s) {
#define K2_CASE(SS)                                                                      \
    case SS:                                                                             \
        if constexpr (32 * W * SS <= MAX_N)                                              \
            return launch_sweep_step<SS, W>(B, n, m, rounds, index_base, seed, order,     \
                                            leader, faulty, alive, ok, dec, s);          \
        break;
    switch (S) { K2_CASE(1) K2_CASE(2) K2_CASE(4) K2_CASE(8) K2_CASE(16) K2_CASE(32) }
#undef K2_CASE
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ba_sweep_step(int B, int n, int m, int rounds, int index_base, const void* seed,
                             const void* order, const void* leader, const void* faulty,
                             const void* alive, const void* ok, void* dec, void* stream) {
    if (B < 1 || n < 1 || n > MAX_N || m < 0 || rounds < 1 || index_base < 0)
        return (int)cudaErrorInvalidValue;
    int S, W;
    lane_layout(n, S, W);
    const cudaStream_t s = (cudaStream_t)stream;
    if (W == 1 && S == 1)  // n <= 32: one word, one lane an instance
        return (int)launch_sweep_step<1, 1>(B, n, m, rounds, index_base, seed, order, leader,
                                            faulty, alive, ok, dec, s);
    return (int)launch_words<LANE_WORDS>(S, B, n, m, rounds, index_base, seed, order, leader,
                                         faulty, alive, ok, dec, s);
}

extern "C" int ba_philox4x32_10(int count, const void* in, void* out, void* stream) {
    if (count < 1) return (int)cudaErrorInvalidValue;
    philox_kernel<<<(count + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        count, (const uint32_t*)in, (uint32_t*)out);
    return (int)cudaGetLastError();
}
