// The per-lane bodies of the Ed25519 kernels (ba_tpu_torch/ops/csrc/*.cu)
// and of pow_planes' field exponentiations (powchain.cu),
// of the field-multiply probe (fieldmul_probe.cu) and of K9 (majority.cu), compiled as host
// C++ and looped over lanes, so the CPU tests can hold the kernels'
// arithmetic against the plain versions without a card.  The CUDA launch
// code in each source sits behind __CUDACC__ and is not compiled here;
// K4's warp-shuffle levels and K3''s fold are replayed in the same
// pairing by fixed_base and window_mult_fold below.
//
//   g++ -O1 -shared -fPIC -I ba_tpu_torch/ops/csrc tests/torch_csrc_host.cpp -o host.so

#include <cstdlib>

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

extern "C" {

void host_decompress(int n, const uint8_t* enc, uint8_t* pts, uint8_t* ok) {
    for (int i = 0; i < n; i++) decompress_lane(enc + 32 * i, pts + 128 * i, ok + i);
}

void host_sha512_modl(int n, int n_blocks, const int64_t* wh, const int64_t* wl, uint8_t* out) {
    for (int i = 0; i < n; i++)
        sha512_modl_lane(wh + 16 * n_blocks * i, wl + 16 * n_blocks * i, n_blocks, out + 32 * i);
}

void host_sha512(int n, int n_blocks, const int64_t* wh, const int64_t* wl, uint8_t* out) {
    for (int i = 0; i < n; i++)
        sha512_lane(wh + 16 * n_blocks * i, wl + 16 * n_blocks * i, n_blocks, out + 64 * i);
}

void host_modl(int n, const uint8_t* in, uint8_t* out) {
    for (int i = 0; i < n; i++) modl_lane(in + 64 * i, out + 32 * i);
}

void host_compress(int n, const uint8_t* pts, uint8_t* enc) {
    for (int i = 0; i < n; i++) compress_lane(pts + 128 * i, enc + 32 * i);
}

void host_fixed_base(int n, const uint8_t* s, const uint8_t* table, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        ge part[8];
        for (int p = 0; p < 8; p++) tree8_part(part[p], table, s + 32 * i, p);
        for (int m = 1; m < 8; m <<= 1) {  // the kernel's shuffle levels
            ge next[8];
            for (int p = 0; p < 8; p++) {
                const bool upper = (p & m) != 0;
                ge lo, hi;
                ge_select(lo, part[p ^ m], part[p], upper);
                ge_select(hi, part[p], part[p ^ m], upper);
                ge_add(next[p], lo, hi);
            }
            for (int p = 0; p < 8; p++) part[p] = next[p];
        }
        ge_tobytes4(out + 128 * i, part[0]);
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

void host_window_verify(int n, const uint8_t* a, const uint8_t* h, const uint8_t* r,
                        const uint8_t* left, uint8_t* ok) {
    for (int i = 0; i < n; i++)
        ok[i] = window_verify_lane(a + 128 * i, h + 32 * i, r + 128 * i, left + 128 * i) ? 1 : 0;
}

// K3''s lane for a k of nbytes, through the instance the kernel launches.
static void mult_lane(int nbytes, const uint8_t* pt, const uint8_t* k, ge& acc) {
    if (!with_k3p_length(nbytes, [&](auto nb) { window_mult_lane<decltype(nb)::value>(pt, k, acc); }))
        abort();  // a length K3' is not built for
}

void host_window_mult(int n, int nbytes, const uint8_t* pt, const uint8_t* k, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        ge acc;
        mult_lane(nbytes, pt + 128 * i, k + nbytes * i, acc);
        ge_tobytes4(out + 128 * i, acc);
    }
}

// The fold kernel's halving tree over one warp: lane t adds lane t + o for
// o = 16, 8, 4, 2, 1; lane 0 ends with the sum.
static void halving_sum(ge v[32]) {
    for (int o = 16; o > 0; o >>= 1)
        for (int t = 0; t < o; t++) ge_add(v[t], v[t], v[t + o]);
}

void host_window_mult_fold(int n, int nbytes, const uint8_t* pt, const uint8_t* k,
                           uint8_t* out) {
    const int blocks = (n + 31) / 32;
    ge* partials = new ge[blocks];
    for (int g = 0; g < blocks; g++) {
        ge v[32];
        for (int t = 0; t < 32; t++) {
            const int lane = 32 * g + t;
            if (lane < n)
                mult_lane(nbytes, pt + 128 * lane, k + nbytes * lane, v[t]);
            else
                ge_identity(v[t]);
        }
        halving_sum(v);
        partials[g] = v[0];
    }
    ge total[32];
    for (int t = 0; t < 32; t++) {
        ge_identity(total[t]);
        for (int row = 0; row * 32 < blocks; row++) {
            ge part;
            if (32 * row + t < blocks)
                part = partials[32 * row + t];
            else
                ge_identity(part);
            ge_add(total[t], total[t], part);
        }
    }
    halving_sum(total);
    ge_tobytes4(out, total[0]);
    delete[] partials;
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

// K9's rows: `lanes` lanes of a row tallied apart, then summed as the warp
// kernel's shuffles sum them (lanes = 1 is the thread-a-row kernel).
void host_majority(long long R, int K, long long S, long long P, int lanes, int words,
                   const uint8_t* a, const uint8_t* v, const int8_t* f, int8_t* out) {
    for (long long r = 0; r < R; r++) {
        Tally t = {0, 0, 0};
        for (int l = 0; l < lanes; l++) {
            const Tally u = tally_lane(a + r * K, v + mask_row(r, S, P) * K, K, words != 0, l,
                                       lanes);
            t.att += u.att;
            t.ret += u.ret;
            t.elig += u.elig;
        }
        out[r] = majority_of(t, f[r]);
    }
}

}  // extern "C"
