// K1's coin arithmetic (megastep.cu), shared with the host build of the
// tests (tests/torch_csrc_host.cpp): threefry2x32, the packed coin words
// of jax's partitionable mode, and the word-batched coin counts.
//
// A coin_bits draw of N coins under key k has nw = ceil(N / 32) words;
// word w is y0 ^ y1 of tf(k, (0, w)) and coin e is bit e / nw of word
// e % nw.  So one word carries 32 coins, e = w, w + nw, w + 2 nw, ...:
// the kernel draws a word once and uses every bit of it.
//
// - Round-1 coins (N = n, nw1 = ceil(n / 32) words): bit k of word w is
//   the coin of recipient j = k * nw1 + w (round1_need).
// - Cube coins (N = n * n, asker i, responder j, e = i * n + j):
//   - n a multiple of 32: nw2 = n * Q with Q = n / 32, so word
//     w = q * n + j (q = i mod Q) holds in bit k the coin of asker
//     i = k * Q + q and responder j.  The Q words of a responder carry its
//     coins to every asker (column_word).  A warp takes one column q,
//     one responder a lane, transposes the 32 x 32 bit block (five
//     shuffle stages, transpose_stage) and lane k pops the coins of asker
//     k * Q + q: counts without atomics and without division.
//   - any other n: bit k of word w is e = k * nw2 + w, so bit k of the 32
//     words w0 .. w0 + 31 is the run of 32 coins from e0 = k * nw2 + w0 of
//     the row-major cube (a window).  A warp takes 32 words: lane k builds
//     the need window of bit k from the responders' bitmap (need_window),
//     a transpose hands lane l the need of word w0 + l, lane l draws that
//     word once, a second transpose hands lane k its window of coins, and
//     lane k adds each row's ATTACK coins to the row's asker
//     (count_window).  A lane's (i, j) steps by divmod(stride, n) from
//     window to window (cube_step, cube_advance), so no coin needs a
//     division, and a window costs a few operations a row it meets, not
//     one a coin.
//
// A build that defines COIN_DRAWN(k) before including this header counts
// the threefry words it evaluates: k at a call (megastep.cu's counting
// build, the host tests).

#pragma once
#include <stdint.h>

#ifndef COIN_DRAWN
#define COIN_DRAWN(k) ((void)0)
#endif

#if defined(__CUDACC__)
#define COIN_FN __host__ __device__ __forceinline__
#else
#define COIN_FN static inline
#endif

COIN_FN uint32_t rotl32(uint32_t x, int r) {
#if defined(__CUDA_ARCH__)
    return __funnelshift_l(x, x, r);
#else
    return (x << r) | (x >> (32 - r));
#endif
}

COIN_FN int popc_u32(uint32_t x) {
#if defined(__CUDA_ARCH__)
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

COIN_FN void tf2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1, uint32_t& y0,
                    uint32_t& y1) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
#define TF_MIX(r)          \
    x0 += x1;              \
    x1 = rotl32(x1, r);    \
    x1 ^= x0;
    TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
    x0 += k1; x1 += k2 + 1u;
    TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
    x0 += k2; x1 += k0 + 2u;
    TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
    x0 += k0; x1 += k1 + 3u;
    TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
    x0 += k1; x1 += k2 + 4u;
    TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
    x0 += k2; x1 += k0 + 5u;
#undef TF_MIX
    y0 = x0;
    y1 = x1;
}

// Word w of a coin_bits draw under key (k0, k1).
COIN_FN uint32_t coin_word(uint32_t k0, uint32_t k1, uint32_t w) {
    uint32_t y0, y1;
    COIN_DRAWN(1);
    tf2x32(k0, k1, 0u, w, y0, y1);
    return y0 ^ y1;
}

// The recipients of round-1 word w that need their coin: bit k for
// recipient j = k * nw1 + w (j < n) where need(j).
template <class Need>
COIN_FN uint32_t round1_need(int w, int n, int nw1, Need need) {
    uint32_t mask = 0u;
    for (int k = 0, j = w; k < 32 && j < n; ++k, j += nw1)
        if (need(j)) mask |= 1u << k;
    return mask;
}

// n a multiple of 32: the word of responder j for column q, holding in
// bit k the coin of asker k * Q + q, kept only where `askers` (bit k: that
// asker counts) has a bit other than the self pair's (j = jk * Q + jq).
// Returns 0, drawing nothing, where no bit is needed.
COIN_FN uint32_t column_word(uint32_t k0, uint32_t k1, int n, int q, int j, int jq, int jk,
                             uint32_t askers) {
    const uint32_t need = askers & ~(jq == q ? 1u << jk : 0u);
    if (!need) return 0u;
    return coin_word(k0, k1, (uint32_t)q * (uint32_t)n + (uint32_t)j) & need;
}

// The bit pattern of stage s (16, 8, 4, 2, 1) of the 32 x 32 transpose:
// the bits whose index has bit s clear.
COIN_FN uint32_t transpose_mask(int s) {
    switch (s) {
        case 16: return 0x0000FFFFu;
        case 8: return 0x00FF00FFu;
        case 4: return 0x0F0F0F0Fu;
        case 2: return 0x33333333u;
        default: return 0x55555555u;
    }
}

// One stage of the warp's bit transpose: `other` is lane (lane ^ s)'s
// word.  A lane with bit s clear keeps its low-half bits and takes its
// partner's low half into its high half; the other lane the reverse.
// After stages 16, 8, 4, 2, 1, bit l of lane k is bit k of lane l's input.
COIN_FN uint32_t transpose_stage(uint32_t x, uint32_t other, int lane, int s) {
    const uint32_t m = transpose_mask(s);
    return (lane & s) ? (x & ~m) | ((other & ~m) >> s) : (x & m) | ((other & m) << s);
}

// Any n: a position in the row-major cube, e = i * n + j.
struct CubePos {
    int i, j;
};

COIN_FN CubePos cube_pos(long long e, int n) {
    return CubePos{static_cast<int>(e / n), static_cast<int>(e % n)};
}

// The step of a position by `stride` coins, divmod(stride, n).
COIN_FN CubePos cube_step(int n, int stride) {
    return CubePos{stride / n, stride % n};
}

COIN_FN void cube_advance(CubePos& p, CubePos st, int n) {
    p.i += st.i;
    p.j += st.j;
    if (p.j >= n) {
        p.j -= n;
        ++p.i;
    }
}

// Bits [j, j + len) of a bitmap of 32-bit words as bits 0 .. len - 1
// (0 < len <= 32; the word after j's is read only where the run reaches
// it).
COIN_FN uint32_t bitmap_bits(const uint32_t* map, int j, int len) {
    const int w = j >> 5, s = j & 31;
    uint32_t v = map[w] >> s;
    if (s + len > 32) v |= map[w + 1] << (32 - s);
    return len == 32 ? v : v & ((1u << len) - 1u);
}

// The need window at p (e0 = p.i * n + p.j): bit l is set where coin
// e0 + l (l < len, e0 + l < n * n) is needed: its asker counts
// (asker(i)), its responder draws coins (bit j of `resp`) and i != j.
template <class Asker>
COIN_FN uint32_t need_window(CubePos p, int n, int len, const uint32_t* resp, Asker asker) {
    uint32_t win = 0u;
    int pos = 0, i = p.i, j = p.j;
    while (pos < len && i < n) {
        const int seg = len - pos < n - j ? len - pos : n - j;
        if (asker(i)) {
            uint32_t r = bitmap_bits(resp, j, seg);
            if (i >= j && i < j + seg) r &= ~(1u << (i - j));
            win |= r << pos;
        }
        pos += seg;
        j = 0;
        ++i;
    }
    return win;
}

// Calls add(i, c) for each asker i with c > 0 of its coins set in `coins`,
// the window of coins at p.
template <class Add>
COIN_FN void count_window(CubePos p, int n, uint32_t coins, Add add) {
    int pos = 0, i = p.i, j = p.j;
    while (pos < 32 && (coins >> pos) != 0u) {
        const int seg = 32 - pos < n - j ? 32 - pos : n - j;
        const uint32_t bits = (coins >> pos) & (seg == 32 ? ~0u : (1u << seg) - 1u);
        if (bits) add(i, popc_u32(bits));
        pos += seg;
        j = 0;
        ++i;
    }
}
