// K5: SHA-512 of padded blocks, then the digest mod L; and K5': the same
// compression with the 64-byte digest written out.  One thread a lane; K5
// in 128-thread blocks, K5' in 32-thread ones.
//
// K5 replaces ba_tpu/ops/sha512_kernel.py::_sha_modl_kernel (the Pallas
// TPU kernel), which chains the compression into ba_tpu/ops/modl.py::
// modl_core without writing the digest out; K5' replaces _sha_kernel in
// the same file, the raw compression (the signer's key expansion
// SHA-512(sk)).  On the TPU a 64-bit word is an (hi, lo) pair of uint32
// planes; here it is a native uint64_t, and the 80 rounds unroll with the
// message schedule in a 16-word ring of registers.  The halves come in as
// 16-byte vectors (two a load).  The digest's bytes are the big-endian
// state words, so its 16 little-endian 32-bit words are the state's
// halves byte-swapped (one byte permute each): K5 hands those words
// straight to modl.cuh's word-form reduction, and K5' stores them as four
// 16-byte vectors.  The reference's _sha_kernel writes the 16 state
// halves; K5' writes the digest's bytes, which is what its caller hashes
// them into.
//
// Bound: operations.  A block is 80 rounds of 64-bit additions, rotations
// and logic on 32-bit pipes (chip_smoke.SHA_BLOCK_OPS counts one block in
// the SASS); the mod-L reduction after it is a few hundred more.  The
// bytes (256 a block in, as (hi, lo) int64 halves, 32 or 64 out) are far
// below.  The design keeps the block and the digest in registers.  The
// rounds hold no waste to take out (a rotate is two funnel shifts, a
// three-way XOR one LOP3 a half, K[t] an operand of the adds), and one
// warp alone issues its ~3 600 instructions at about one every two
// cycles: the integer pipe's rate for one scheduler, not a latency chain.
// So the time at width is the most warps any scheduler holds: K5' runs
// in 32-thread blocks, which spread the signer's 20 480 lanes over the
// SMs in 640 blocks rather than 160 of 128 threads.
//
// Interface: wh, wl int64 [n, n_blocks, 16] (big-endian 32-bit halves of
// the padded message words, as ba_tpu/crypto/sha512.py::_message_words
// lays them out; each base 16-byte aligned, which the wrapper checks) ->
// K5: out uint8 [n, 32] = SHA-512(message) mod L, little endian; K5': out
// uint8 [n, 64] = SHA-512(message).

#include "modl.cuh"

// FIPS 180-4's round constants and initial state; held against the plain
// module's computed values by tests/test_torch_sha512.py.
ED_CONST uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};
ED_CONST uint64_t SHA512_H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

ED_FN uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

ED_FN void sha512_block(uint64_t st[8], uint64_t w[16]) {
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

// Two int64 halves: one 16-byte vector load on the card.
#if defined(__CUDACC__)
typedef longlong2 sha512_halves;
#else
struct sha512_halves {
    long long x, y;
};
#endif

// The state after n_blocks blocks from the initial state.
ED_FN void sha512_state(uint64_t st[8], const int64_t* wh, const int64_t* wl, int n_blocks) {
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
        sha512_block(st, w);
    }
}

ED_FN uint32_t sha512_bswap32(uint32_t x) {
#if defined(__CUDACC__)
    return __byte_perm(x, 0, 0x0123);
#else
    return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) | (x << 24);
#endif
}

// The digest as four 16-byte vectors of little-endian words: state word
// j is digest bytes 8j..8j+7, big endian.
ED_FN void sha512_digest(const int64_t* wh, const int64_t* wl, int n_blocks, modl_vec d[4]) {
    uint64_t st[8];
    sha512_state(st, wh, wl, n_blocks);
#pragma unroll
    for (int k = 0; k < 4; k++)
        d[k] = modl_vec{sha512_bswap32((uint32_t)(st[2 * k] >> 32)),
                        sha512_bswap32((uint32_t)st[2 * k]),
                        sha512_bswap32((uint32_t)(st[2 * k + 1] >> 32)),
                        sha512_bswap32((uint32_t)st[2 * k + 1])};
}

ED_FN void sha512_modl_lane(const int64_t* wh, const int64_t* wl, int n_blocks, modl_vec* out) {
    modl_vec d[4], r[2];
    sha512_digest(wh, wl, n_blocks, d);
    modl_vecs(d, r);
    out[0] = r[0];
    out[1] = r[1];
}

ED_FN void sha512_lane(const int64_t* wh, const int64_t* wl, int n_blocks, modl_vec* out) {
    modl_vec d[4];
    sha512_digest(wh, wl, n_blocks, d);
#pragma unroll
    for (int k = 0; k < 4; k++) out[k] = d[k];
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) sha512_modl_kernel(int n, int n_blocks,
                                                          const int64_t* __restrict__ wh,
                                                          const int64_t* __restrict__ wl,
                                                          modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    sha512_modl_lane(wh + off, wl + off, n_blocks, out + 2 * (size_t)lane);
}

__global__ void __launch_bounds__(32) sha512_kernel(int n, int n_blocks,
                                                    const int64_t* __restrict__ wh,
                                                    const int64_t* __restrict__ wl,
                                                    modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    sha512_lane(wh + off, wl + off, n_blocks, out + 4 * (size_t)lane);
}

extern "C" int ba_sha512_modl(int n, int n_blocks, const void* wh, const void* wl, void* out,
                              void* stream) {
    if (n <= 0) return 0;
    sha512_modl_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (modl_vec*)out);
    return (int)cudaGetLastError();
}

extern "C" int ba_sha512(int n, int n_blocks, const void* wh, const void* wl, void* out,
                         void* stream) {
    if (n <= 0) return 0;
    sha512_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (modl_vec*)out);
    return (int)cudaGetLastError();
}

#endif
