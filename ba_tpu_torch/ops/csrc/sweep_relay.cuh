// K2's relay arithmetic (sweep_step.cu), shared with the host build of the
// tests (tests/torch_csrc_host.cpp): the packed relay word a lane
// contributes to its instance's one sum a relay round, and the branch-free
// threshold read back from that sum.
//
// A lane holds generals of one instance as bits of masks.  Its word packs
// four fields:
//   bits  0- 8  min(popc(seen_r & traitor), 9) over the lane's words
//   bits  9-17  min(popc(seen_a & traitor), 9)
//   bits 18-23  (seen_r & honest) != 0
//   bits 24-29  (seen_a & honest) != 0
// One add over the instance's lanes (at most 32) sums all four: a traitor
// field is at most 32 x 9 = 288 (9 bits), a held field at most 32 (6
// bits).  Capping a lane's traitor count at 9 is exact because the
// threshold saturates for k > 8: a capped sum is 9 or more exactly when
// the true count is.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define RELAY_FN __host__ __device__ __forceinline__
#else
#define RELAY_FN static inline
#endif

RELAY_FN int relay_popc(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

RELAY_FN uint32_t relay_cap9(int k) { return (uint32_t)(k < 9 ? k : 9); }

// One lane's packed relay word from its traitor holder counts and honest
// holder flags of each value.
RELAY_FN uint32_t relay_word(int k_r, int k_a, bool held_r, bool held_a) {
    return relay_cap9(k_r) | relay_cap9(k_a) << 9 | (uint32_t)held_r << 18 |
           (uint32_t)held_a << 24;
}

// The relay threshold of value v (0 RETREAT, 1 ATTACK) from an
// instance's summed word: 256 when an honest general holds v; else, while
// the chain bound allows (chain_ok: r < t), 256 - (256 >> k) for k
// traitor holders capped at 9 (0 at k = 0, 255 at k = 8, 256 from k = 9
// on); else 0.  Selects, no branches.
RELAY_FN int relay_threshold(uint32_t sum, int v, bool chain_ok) {
    const uint32_t k = relay_cap9((int)((sum >> (9 * v)) & 0x1FFu));
    const bool held = ((sum >> (18 + 6 * v)) & 0x3Fu) != 0u;
    const int coin = chain_ok ? 256 - (256 >> k) : 0;
    return held ? 256 : coin;
}
