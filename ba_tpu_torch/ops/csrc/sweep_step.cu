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
// Layout: one warp per instance, four instances a block.  Lane L holds
// generals j = L + 32 i (i < 32) as bit i of 32-bit masks (alive, honest,
// traitor, seen-RETREAT, seen-ATTACK), read once from device memory and
// kept in registers across all rounds.  A relay round is a handful of
// mask operations a lane; the four counts a relay round needs (honest
// and traitor holders of each value) are one __reduce_add_sync of two
// packed 16-bit traitor counts and two __any_sync votes, so the block
// never synchronises and uses no shared memory.  The TPU kernel's
// [TILE, n] planes in VMEM and its row reductions become these registers
// and warp reductions.
//
// Randomness: Philox4x32-10, written out here and in the plain version
// (ba_tpu_torch/ops/sweep_step.py) so the two are bit-equal; no library
// generator.  Key (seed, b), counter (rr, j, d / 4, 0), draw d = word
// d % 4: d = 0 the round-1 coin (bit 0), d = r relay round r (byte 0 for
// RETREAT, byte 1 for ATTACK).  A draw is computed only where its value
// can matter: alive non-leader recipients of a faulty leader, and alive
// generals in a relay round whose threshold lies strictly inside (0, 256).
//
// Bound: operations.  Per instance-round the work is a few dozen integer
// operations a 32-general mask word per relay round, plus one Philox call
// (40 32-bit multiplies, 80 operations) for each draw that matters; the
// state (2 bytes a general) is read once and one byte a round written.
// On the signed sweep with honest leaders and valid tables no draw
// matters and the kernel is the mask arithmetic and warp reductions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_N = 1024;  // 32 generals a lane
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

// The relay threshold of one value: 256 when an honest general holds it,
// else the OR-of-k-coins threshold while the chain bound allows, else 0.
__device__ __forceinline__ int relay_threshold(bool held, int k, bool chain_ok) {
    if (held) return 256;
    if (!chain_ok) return 0;
    return k > 8 ? 256 : 256 - (256 >> k);
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sweep_step_kernel(int B, int n, int m, int rounds, const int32_t* __restrict__ seed_p,
                  const int8_t* __restrict__ order, const int32_t* __restrict__ leader,
                  const uint8_t* __restrict__ faulty, const uint8_t* __restrict__ alive,
                  const uint8_t* __restrict__ ok, int8_t* __restrict__ dec) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (b >= B) return;  // b is warp-uniform: whole warps leave
    const uint32_t seed = (uint32_t)seed_p[0];
    const size_t row = (size_t)b * n;
    const int slots = (n + 31) >> 5;

    uint32_t alive_m = 0u, faulty_m = 0u;
    for (int i = 0; i < slots; ++i) {
        const int j = lane + 32 * i;
        if (j < n) {
            alive_m |= (uint32_t)(alive[row + j] != 0) << i;
            faulty_m |= (uint32_t)(faulty[row + j] != 0) << i;
        }
    }
    const uint32_t honest_m = alive_m & ~faulty_m;
    const uint32_t traitor_m = alive_m & faulty_m;

    const int ord = order[b];
    const int ldr = leader[b];
    const bool ldr_ok = ldr >= 0 && ldr < n;
    const bool leader_faulty = ldr_ok && faulty[row + ldr] != 0;
    const uint32_t leader_bit = (ldr_ok && (ldr & 31) == lane) ? (1u << (ldr >> 5)) : 0u;
    const uint32_t ord_a = ord == 1 ? FULL : 0u;  // the leader's own value, as masks
    const uint32_t ord_r = ord == 0 ? FULL : 0u;
    const uint32_t ok_r = ok[2 * b] ? FULL : 0u;
    const uint32_t ok_a = ok[2 * b + 1] ? FULL : 0u;

    const int t = __reduce_add_sync(FULL, __popc(traitor_m));
    const int total = __reduce_add_sync(FULL, __popc(alive_m));
    int needed = total >= 1 ? 2 * ((total - 1) / 3) + 1 : 0;
    if (total <= 3) needed = total - 1;
    if (total == 1) needed = 1;

    for (int rr = 0; rr < rounds; ++rr) {
        // Round 1 and the signature gate.
        uint32_t recv_a = ord_a, recv_r = ord_r;
        if (leader_faulty) {
            uint32_t coins = 0u;
            for (uint32_t todo = alive_m & ~leader_bit; todo; todo &= todo - 1) {
                const int i = __ffs(todo) - 1;
                coins |= (philox_word(rr, lane + 32 * i, 0, seed, b) & 1u) << i;
            }
            recv_a = coins;
            recv_r = ~coins;
        }
        recv_a = (recv_a & ~leader_bit) | (ord_a & leader_bit);
        recv_r = (recv_r & ~leader_bit) | (ord_r & leader_bit);
        uint32_t seen_r = recv_r & alive_m & ok_r;
        uint32_t seen_a = recv_a & alive_m & ok_a;

        // m collapsed relay rounds.
        for (int r = 1; r <= m; ++r) {
            const int k = __reduce_add_sync(
                FULL, __popc(seen_r & traitor_m) | (__popc(seen_a & traitor_m) << 16));
            const bool held_r = __any_sync(FULL, (seen_r & honest_m) != 0u);
            const bool held_a = __any_sync(FULL, (seen_a & honest_m) != 0u);
            const int th_r = relay_threshold(held_r, k & 0xFFFF, r < t);
            const int th_a = relay_threshold(held_a, k >> 16, r < t);
            const bool draw_r = th_r > 0 && th_r < 256;
            const bool draw_a = th_a > 0 && th_a < 256;
            uint32_t fire_r = th_r >= 256 ? alive_m : 0u;
            uint32_t fire_a = th_a >= 256 ? alive_m : 0u;
            if (draw_r || draw_a) {
                for (uint32_t todo = alive_m; todo; todo &= todo - 1) {
                    const int i = __ffs(todo) - 1;
                    const uint32_t w = philox_word(rr, lane + 32 * i, r, seed, b);
                    if (draw_r && (int)(w & 0xFFu) < th_r) fire_r |= 1u << i;
                    if (draw_a && (int)((w >> 8) & 0xFFu) < th_a) fire_a |= 1u << i;
                }
            }
            seen_r = (seen_r | fire_r) & alive_m;
            seen_a = (seen_a | fire_a) & alive_m;
        }

        // choice(V), the counts over alive generals, the quorum.
        const uint32_t maj_a = (seen_a & ~seen_r & ~leader_bit) | (ord_a & leader_bit);
        const uint32_t maj_r = (seen_r & ~seen_a & ~leader_bit) | (ord_r & leader_bit);
        const int cnt = __reduce_add_sync(
            FULL, __popc(maj_a & alive_m) | (__popc(maj_r & alive_m) << 16));
        if (lane == 0) {
            const int n_a = cnt & 0xFFFF, n_r = cnt >> 16;
            int8_t d = 2;  // UNDEFINED
            if (total > 0) d = needed <= n_r ? 0 : (needed <= n_a ? 1 : 2);
            dec[(size_t)b * rounds + rr] = d;
        }
    }
}

}  // namespace

extern "C" int ba_sweep_step(int B, int n, int m, int rounds, const void* seed,
                             const void* order, const void* leader, const void* faulty,
                             const void* alive, const void* ok, void* dec, void* stream) {
    if (B < 1 || n < 1 || n > MAX_N || m < 0 || rounds < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
    sweep_step_kernel<<<grid, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
        B, n, m, rounds, (const int32_t*)seed, (const int8_t*)order, (const int32_t*)leader,
        (const uint8_t*)faulty, (const uint8_t*)alive, (const uint8_t*)ok, (int8_t*)dec);
    return (int)cudaGetLastError();
}

extern "C" int ba_philox4x32_10(int count, const void* in, void* out, void* stream) {
    if (count < 1) return (int)cudaErrorInvalidValue;
    philox_kernel<<<(count + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        count, (const uint32_t*)in, (uint32_t*)out);
    return (int)cudaGetLastError();
}
