// The per-lane bodies of the Ed25519 kernels (ba_tpu_torch/ops/csrc/*.cu)
// and of pow_planes' field exponentiations (powchain.cu),
// of the field-multiply probe (fieldmul_probe.cu) and of K9 (majority.cu), compiled as host
// C++ and looped over lanes, and K1's word-batched coin counts (coins.cuh)
// and K2's packed relay word (sweep_relay.cuh) with the warps' shuffles
// replayed, so the CPU tests can hold the kernels'
// arithmetic against the plain versions without a card.  The CUDA launch
// code in each source sits behind __CUDACC__ and is not compiled here;
// K4's warp-shuffle levels (at each thread count a lane) and K3''s sum
// (its warps' halving trees and the tree over the blocks) are replayed in
// the same pairing by fixed_base and window_mult_sum8 below; the window
// table, shared memory on the card, is an array a lane here (STRIDE 1).
//
//   g++ -O1 -shared -fPIC -I ba_tpu_torch/ops/csrc tests/torch_csrc_host.cpp -o host.so

#include <cstdlib>
#include <cstring>
#include <vector>

// Every threefry word coins.cuh evaluates is counted here: the words drawn.
static long long coin_words_drawn = 0;
#define COIN_DRAWN(k) (coin_words_drawn += (k))
#include "coins.cuh"
#include "sweep_relay.cuh"

#include "decompress.cu"
#include "fieldmul_probe.cu"
#include "majority.cu"
#include "modl.cu"
#include "powchain.cu"
#include "scalar_mult.cu"
#include "sha512_modl.cu"
#include "treeadd.cu"
#include "window_mult.cu"
#include "window_verify.cu"
// q + q by squarings, the doubling K3''s bound counts (no shipped kernel
// runs it).
#include "../scripts/k3ppk5p_variants/ge_add_self.cuh"

extern "C" {

void host_decompress(int n, const uint8_t* enc, uint8_t* pts, uint8_t* ok) {
    for (int i = 0; i < n; i++) decompress_lane(enc + 32 * i, pts + 128 * i, ok + i);
}

void host_sha512_modl(int n, int n_blocks, const int64_t* wh, const int64_t* wl, uint8_t* out) {
    for (int i = 0; i < n; i++)
        sha512_modl_lane(wh + 16 * n_blocks * i, wl + 16 * n_blocks * i, n_blocks,
                         (modl_vec*)(out + 32 * i));
}

void host_sha512(int n, int n_blocks, const int64_t* wh, const int64_t* wl, uint8_t* out) {
    for (int i = 0; i < n; i++)
        sha512_lane(wh + 16 * n_blocks * i, wl + 16 * n_blocks * i, n_blocks,
                    (modl_vec*)(out + 64 * i));
}

void host_modl(int n, const uint8_t* in, uint8_t* out) {
    for (int i = 0; i < n; i++) modl_lane((const modl_vec*)(in + 64 * i), (modl_vec*)(out + 32 * i));
}

void host_compress(int n, const uint8_t* pts, uint8_t* enc) {
    for (int i = 0; i < n; i++) compress_lane(pts + 128 * i, enc + 32 * i);
}

// K4 at T threads a lane: each thread's subtree, then the kernel's shuffle
// levels, the lower partner of each pair adding the upper one's sum.
extern "C++" {
template <int T>
static void fixed_base_lanes(int n, const uint8_t* s, const int32_t* table, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        ge part[T];
        for (int p = 0; p < T; p++) fb_part<T>(part[p], table, s + 32 * i, p);
        for (int m = 1; m < T; m <<= 1)
            for (int p = 0; p < T; p += 2 * m) ge_add(part[p], part[p], part[p + m]);
        ge_tobytes4(out + 128 * i, part[0]);
    }
}
}  // extern "C++"

void host_fixed_base(int n, int threads, const uint8_t* s, const int32_t* table, uint8_t* out) {
    switch (threads) {
        case 1: fixed_base_lanes<1>(n, s, table, out); break;
        case 2: fixed_base_lanes<2>(n, s, table, out); break;
        case 4: fixed_base_lanes<4>(n, s, table, out); break;
        case 8: fixed_base_lanes<8>(n, s, table, out); break;
        default: abort();
    }
}

// fe_sq and fe_mul(f, f) of the same limbs, as canonical encodings.
void host_fe_sq(int n, const int32_t* f, uint8_t* sq, uint8_t* mul) {
    for (int i = 0; i < n; i++) {
        fe a, s, m;
        fe_load(a, f + 10 * i);
        fe_sq(s, a);
        fe_mul(m, a, a);
        fe_tobytes(sq + 32 * i, s);
        fe_tobytes(mul + 32 * i, m);
    }
}

// The kernels' warp test (window.cuh warp_one_point): whether lanes
// [32 (i / 32), n) of lane i's warp all hold its first lane's point.
static bool warp_one_point_host(const uint8_t* pts, int n, int i) {
    const int first = i - i % 32, end = first + 32 < n ? first + 32 : n;
    for (int j = first + 1; j < end; j++)
        if (memcmp(pts + 128 * j, pts + 128 * first, 128) != 0) return false;
    return true;
}

// A table big enough for either chain, as the card's block holds.
static int32_t host_tab[K3P_TABLE_WORDS > WARP_TABLE_WORDS ? K3P_TABLE_WORDS : WARP_TABLE_WORDS];

void host_window_verify(int n, const uint8_t* a, const uint8_t* h, const uint8_t* r,
                        const uint8_t* left, uint8_t* ok) {
    for (int i = 0; i < n; i++)
        ok[i] = window_verify_lane<1>(a + 128 * i, h + 32 * i, r + 128 * i, left + 128 * i,
                                      host_tab, 0, warp_one_point_host(a, n, i)) ? 1 : 0;
}

// K3''s lane for a k of nbytes, through the instance a kernel launches
// (32 bytes, or 16 in the sum's [z]R blocks, which never take the warp's
// one table).
static void mult_lane(int nbytes, const uint8_t* pt, const uint8_t* k, bool warp_point,
                      ge& acc) {
    if (nbytes == 32)
        window_mult_lane<32, 1>(pt, k, host_tab, 0, warp_point, acc);
    else if (nbytes == 16)
        window_mult_lane<16, 1>(pt, k, host_tab, 0, warp_point, acc);
    else
        abort();  // a length K3' is not built for
}

void host_window_mult(int n, int nbytes, const uint8_t* pt, const uint8_t* k, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        ge acc;
        mult_lane(nbytes, pt + 128 * i, k + nbytes * i, warp_one_point_host(pt, n, i), acc);
        ge_tobytes4(out + 128 * i, acc);
    }
}

// The recoded digits of k (window.cuh) in windows of wbits (the lanes'
// WINDOW_BITS or the warp's WARP_WINDOW_BITS), as the accumulator reads
// them: digits[0] the carry digit, then the NWIN windows' digits, most
// significant first (1 + NWIN a lane).
extern "C++" {
template <int NBYTES, int WBITS>
static void recode_lanes(int n, const uint8_t* k, int32_t* digits) {
    using R = Recoding<NBYTES, WBITS>;
    for (int i = 0; i < n; i++) {
        uint32_t u[R::WORDS + 1];
        int32_t* d = digits + (1 + R::NWIN) * i;
        d[0] = recode_start<NBYTES, WBITS>(u, k + NBYTES * i);
        for (int w = 1; w <= R::NWIN; w++) d[w] = recode_next<NBYTES, WBITS>(u);
    }
}
}  // extern "C++"

void host_recode(int n, int nbytes, int wbits, const uint8_t* k, int32_t* digits) {
    const bool lane_bits = wbits == WINDOW_BITS;
    if (!lane_bits && wbits != WARP_WINDOW_BITS) abort();
    if (nbytes == 32 && lane_bits)
        recode_lanes<32, WINDOW_BITS>(n, k, digits);
    else if (nbytes == 32)
        recode_lanes<32, WARP_WINDOW_BITS>(n, k, digits);
    else if (nbytes == 16 && lane_bits)
        recode_lanes<16, WINDOW_BITS>(n, k, digits);
    else if (nbytes == 16)
        recode_lanes<16, WARP_WINDOW_BITS>(n, k, digits);
    else
        abort();
}

// The sum kernel's halving tree over one warp: lane t adds lane t + o for
// o = 16, 8, 4, 2, 1; lane 0 ends with the sum.
static void halving_sum(ge v[32]) {
    for (int o = 16; o > 0; o >>= 1)
        for (int t = 0; t < o; t++) ge_add(v[t], v[t], v[t + o]);
}

// [8](sum of [ka_j]A_j (32-byte k) + sum of [kz_i]R_i (16-byte k)): the
// blocks of 32 lanes of the A set, then of the R set, each summed by the
// warp's halving tree; the block sums paired level by level (node 2i + 1
// added to node 2i, an odd last node passed up) as the blocks' climb
// pairs them; the root doubled three times.
void host_window_mult_sum8(int na, const uint8_t* pa, const uint8_t* ka, int nz,
                           const uint8_t* pz, const uint8_t* kz, uint8_t* out) {
    const int ga = (na + 31) / 32, gz = (nz + 31) / 32;
    if (ga + gz == 0) abort();
    std::vector<ge> nodes(ga + gz);
    for (int g = 0; g < ga + gz; g++) {
        const bool in_a = g < ga;
        ge v[32];
        for (int t = 0; t < 32; t++) {
            const int lane = 32 * (in_a ? g : g - ga) + t;
            if (in_a && lane < na)
                mult_lane(32, pa + 128 * lane, ka + 32 * lane, false, v[t]);
            else if (!in_a && lane < nz)
                mult_lane(16, pz + 128 * lane, kz + 16 * lane, false, v[t]);
            else
                ge_identity(v[t]);
        }
        halving_sum(v);
        nodes[g] = v[0];
    }
    while (nodes.size() > 1) {
        std::vector<ge> up((nodes.size() + 1) / 2);
        for (size_t i = 0; i < up.size(); i++) {
            if (2 * i + 1 < nodes.size())
                ge_add(up[i], nodes[2 * i], nodes[2 * i + 1]);
            else
                up[i] = nodes[2 * i];
        }
        nodes.swap(up);
    }
    ge_times8(nodes[0]);
    ge_tobytes4(out, nodes[0]);
}

// q + q by squarings (ge_add_self, the doubling K3''s bound counts) and by
// the unified addition (ge_add(q, q)), each as canonical encodings.
void host_ge_add_self(int n, const uint8_t* pts, uint8_t* by_self, uint8_t* by_add) {
    for (int i = 0; i < n; i++) {
        ge p, r;
        ge_frombytes4(p, pts + 128 * i);
        ge_add_self(r, p);
        ge_tobytes4(by_self + 128 * i, r);
        ge_add(r, p, p);
        ge_tobytes4(by_add + 128 * i, r);
    }
}

// K3'': words int32 [nwords, n], word w of lane i at w * n + i.
void host_scalar_mult(int n, int nwords, const uint8_t* pt, const uint32_t* words,
                      uint8_t* out) {
    for (int i = 0; i < n; i++)
        scalar_mult_lane(pt + 128 * i, words + i, nwords, (size_t)n, out + 128 * i);
}

void host_sqrt_chain(int n, const uint8_t* a, uint8_t* out) {
    for (int i = 0; i < n; i++) sqrt_chain_lane(a + 32 * i, out + 32 * i);
}

void host_inv_chain(int n, const uint8_t* a, uint8_t* out) {
    for (int i = 0; i < n; i++) inv_chain_lane(a + 32 * i, out + 32 * i);
}

// K8'': the exponent's words as the launcher copies them into PowExp.
void host_pow(int n, int nbits, const uint32_t* words, const uint8_t* a, uint8_t* out) {
    PowExp e = {};
    for (int i = 0; i < (nbits + 31) / 32; i++) e.w[i] = words[i];
    for (int i = 0; i < n; i++) pow_lane(a + 32 * i, nbits, e.w, out + 32 * i);
}

void host_fieldmul_probe(int n, const uint8_t* a, const uint8_t* b, uint8_t* out) {
    for (int i = 0; i < n; i++) fieldmul_probe_lane(a + 32 * i, b + 32 * i, out + 32 * i);
}

// K9 as ba_majority launches it: K <= 32 tile by tile (the tile staged,
// each of its threads' rows, the store), longer rows a warp's 32 lanes
// summed.  Returns 1 for a shape the kernels do not take.
extern "C++" {
template <int NW>
static void host_tiles(const MajArgs& x, long long tiles) {
    std::vector<uint4> sm(tile_smem_bytes(x.K) / 16);
    uint8_t* s = (uint8_t*)sm.data();
    for (long long b = 0; b < tiles; b++) {
        const TileGeom t = tile_geom(x, b);
        tile_stage(x, t, s, 0, 1);
        for (int tid = 0; tid < TILE_THREADS; tid++) tile_rows<NW>(x, t, s, tid);
        tile_store(x, t, s, 0, 1);
    }
}
}  // extern "C++"

int host_majority(long long R, int K, long long S, long long P, const uint8_t* a,
                  const uint8_t* v, const int8_t* f, int8_t* out) {
    MajArgs x;
    long long blocks;
    if (!maj_args(R, K, S, P, a, v, f, out, x, blocks)) return 1;
    if (K > TILE_MAX_K) {
        for (long long r = 0; r < R; r++) {
            int att = 0, ret = 0;
            bool any = false;
            for (int l = 0; l < 32; l++) {
                int la, lr;
                bool ly;
                warp_lane(x, r, l, 32, la, lr, ly);
                att += la;
                ret += lr;
                any = any || ly;
            }
            out[r] = majority_of(att, ret, any, f[r]);
        }
        return 0;
    }
    switch ((K + 3) / 4) {
        case 1: host_tiles<1>(x, blocks); break;
        case 2: host_tiles<2>(x, blocks); break;
        case 3: host_tiles<3>(x, blocks); break;
        case 4: host_tiles<4>(x, blocks); break;
        case 5: host_tiles<5>(x, blocks); break;
        case 6: host_tiles<6>(x, blocks); break;
        case 7: host_tiles<7>(x, blocks); break;
        default: host_tiles<8>(x, blocks); break;
    }
    return 0;
}

// The warp's 32 x 32 bit transpose (coins.cuh's five stages), lane by lane.
static void host_transpose(uint32_t* x) {
    uint32_t other[32];
    for (int st = 16; st > 0; st >>= 1) {
        for (int lane = 0; lane < 32; lane++) other[lane] = x[lane ^ st];
        for (int lane = 0; lane < 32; lane++) x[lane] = transpose_stage(x[lane], other[lane], lane, st);
    }
}

// K1's coin counts of one instance-round as megastep.cu makes them:
// ones[i] = the ATTACK coins asker i (ask[i] != 0) draws from the coin
// responders (resp[j] != 0, j != i) under the cube key (k0, k1), 0 for
// any other general.  The block's warps are replayed: n a multiple of 32
// a column q a warp, 32 responders a step, the transpose, lane k's
// popcount; any other n the eight warps' windows of 32 words, their
// stride, both transposes and the row counts.  Returns the words drawn
// (coin_word's calls).
int host_coin_counts(int n, uint32_t k0, uint32_t k1, const uint8_t* ask, const uint8_t* resp,
                     int32_t* ones) {
    const long long drawn0 = coin_words_drawn;
    for (int i = 0; i < n; i++) ones[i] = 0;
    if (n % 32 == 0) {
        const int Q = n / 32;
        std::vector<int> ulist;
        for (int j = 0; j < n; j++)
            if (resp[j]) ulist.push_back(j);
        const int u = (int)ulist.size();
        for (int q = 0; q < Q; q++) {
            uint32_t askers = 0u;
            for (int k = 0; k < 32; k++)
                if (ask[k * Q + q]) askers |= 1u << k;
            if (!askers) continue;
            int cnt[32] = {0};
            for (int c0 = 0; c0 < u; c0 += 32) {
                uint32_t x[32];
                for (int lane = 0; lane < 32; lane++) {
                    const int j = c0 + lane < u ? ulist[c0 + lane] : -1;
                    x[lane] = j < 0 ? 0u : column_word(k0, k1, n, q, j, j % Q, j / Q, askers);
                }
                host_transpose(x);
                for (int lane = 0; lane < 32; lane++) cnt[lane] += popc_u32(x[lane]);
            }
            for (int lane = 0; lane < 32; lane++) ones[lane * Q + q] = cnt[lane];
        }
        return (int)(coin_words_drawn - drawn0);
    }
    const int warps = 8;
    const int nw2 = (int)(((long long)n * n + 31) / 32);
    std::vector<uint32_t> resp_bits((n + 31) / 32, 0u);
    for (int j = 0; j < n; j++)
        if (resp[j]) resp_bits[j >> 5] |= 1u << (j & 31);
    auto asker = [&](int i) { return ask[i] != 0; };
    const CubePos stride = cube_step(n, 32 * warps);
    for (int warp = 0; warp < warps; warp++) {
        CubePos pos[32];
        for (int lane = 0; lane < 32; lane++)
            pos[lane] = cube_pos((long long)lane * nw2 + warp * 32, n);
        for (int w0 = warp * 32; w0 < nw2; w0 += 32 * warps) {
            const int len = nw2 - w0 < 32 ? nw2 - w0 : 32;
            uint32_t x[32], any = 0u;
            for (int lane = 0; lane < 32; lane++)
                any |= x[lane] = need_window(pos[lane], n, len, resp_bits.data(), asker);
            if (any) {
                host_transpose(x);
                for (int lane = 0; lane < 32; lane++)
                    x[lane] = x[lane] ? coin_word(k0, k1, (uint32_t)(w0 + lane)) & x[lane] : 0u;
                host_transpose(x);
                for (int lane = 0; lane < 32; lane++)
                    count_window(pos[lane], n, x[lane], [&](int i, int c) { ones[i] += c; });
            }
            for (int lane = 0; lane < 32; lane++) cube_advance(pos[lane], stride, n);
        }
    }
    return (int)(coin_words_drawn - drawn0);
}

// K1's round-1 coins: coin[j] for every recipient with need[j] != 0, -1
// elsewhere, under the round-1 key (k0, k1).  Returns the words drawn.
int host_round1_coins(int n, uint32_t k0, uint32_t k1, const uint8_t* need, int8_t* coin) {
    const long long drawn0 = coin_words_drawn;
    const int nw1 = (n + 31) / 32;
    for (int j = 0; j < n; j++) coin[j] = -1;
    for (int w = 0; w < nw1; w++) {
        const uint32_t mask = round1_need(w, n, nw1, [&](int j) { return need[j] != 0; });
        if (!mask) continue;
        const uint32_t y = coin_word(k0, k1, (uint32_t)w);
        for (int k = 0, j = w; k < 32 && j < n; ++k, j += nw1)
            if ((mask >> k) & 1u) coin[j] = (int8_t)((y >> k) & 1u);
    }
    return (int)(coin_words_drawn - drawn0);
}

// K2's relay round of one instance over `lanes` lanes of `words` mask
// words each (lane l's words at l * words): each lane's counts and flags
// over its words packed, the words summed as a segment sums them, and both
// thresholds.  out[0] = the sum, out[1], out[2] = the RETREAT and ATTACK
// thresholds.
void host_relay(int lanes, int words, const uint32_t* seen_r, const uint32_t* seen_a,
                const uint32_t* honest, const uint32_t* traitor, int chain_ok, int32_t* out) {
    uint32_t sum = 0u;
    for (int l = 0; l < lanes; l++) {
        int k_r = 0, k_a = 0;
        uint32_t held_r = 0u, held_a = 0u;
        for (int w = l * words; w < (l + 1) * words; w++) {
            k_r += relay_popc(seen_r[w] & traitor[w]);
            k_a += relay_popc(seen_a[w] & traitor[w]);
            held_r |= seen_r[w] & honest[w];
            held_a |= seen_a[w] & honest[w];
        }
        sum += relay_word(k_r, k_a, held_r != 0u, held_a != 0u);
    }
    out[0] = (int32_t)sum;
    out[1] = relay_threshold(sum, 0, chain_ok != 0);
    out[2] = relay_threshold(sum, 1, chain_ok != 0);
}

}  // extern "C"
