// K5's and K5''s designs beside the shipped ones (ba_tpu_torch/ops/csrc/
// sha512_modl.cu), for scripts/k6k5_variants.py: a variant number a launch
// of ba_sha512_modl_variant (K5) or ba_sha512_variant (K5'), each output
// held bit-equal to the shipped kernel's.  Every variant runs the shipped
// compression rounds (sha512_block); they differ in how the halves come in
// and the digest goes out.
//
//   K5  0  v12: the previous design: the halves by 8-byte loads, the
//          digest's 64 bytes extracted into int64 byte limbs for the
//          previous mod-L core (modl_variants.cu); 128 threads a block.
//       1  fold: the shipped loads and digest words, then the fold plan
//          (modl_variants.cu's fold_words) in place of Barrett's.
//       2  scalar_loads: the shipped design with v12's 8-byte loads of the
//          halves: what the 16-byte loads move.
//   K5' 0  v12: 8-byte loads, the digest stored byte by byte.
//
// sha512_block_probe, never launched, counts one compression block in SASS
// (scripts/k6k5_variants.py -> chip_smoke.SHA_BLOCK_OPS): the state and
// the block's 16 words loaded, sha512_block, the state stored.
//
// Interface: wh, wl int64 [n, n_blocks, 16] -> K5 uint8 [n, 32], K5'
// uint8 [n, 64].

#include "modl_variants.cu"
#include "sha512_modl.cu"

ED_FN void v12_sha512_state(uint64_t st[8], const int64_t* wh, const int64_t* wl,
                            int n_blocks) {
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = SHA512_H0[i];
#pragma unroll 1
    for (int blk = 0; blk < n_blocks; blk++) {
        uint64_t w[16];
#pragma unroll
        for (int i = 0; i < 16; i++)
            w[i] = ((uint64_t)wh[16 * blk + i] << 32) | ((uint64_t)wl[16 * blk + i] & 0xffffffffULL);
        sha512_block(st, w);
    }
}

#define V12_DIGEST_BYTE(st, k) (((st)[(k) >> 3] >> (56 - 8 * ((k) & 7))) & 0xff)

ED_FN void v12_sha512_modl_lane(const int64_t* wh, const int64_t* wl, int n_blocks,
                                uint8_t* out) {
    uint64_t st[8];
    v12_sha512_state(st, wh, wl, n_blocks);
    int64_t v[64];
#pragma unroll
    for (int k = 0; k < 64; k++) v[k] = (int64_t)V12_DIGEST_BYTE(st, k);
    v12_modl_core(v, out);
}

ED_FN void v12_sha512_lane(const int64_t* wh, const int64_t* wl, int n_blocks, uint8_t* out) {
    uint64_t st[8];
    v12_sha512_state(st, wh, wl, n_blocks);
#pragma unroll
    for (int k = 0; k < 64; k++) out[k] = (uint8_t)V12_DIGEST_BYTE(st, k);
}

// K5 with the shipped digest words and plan PLAN's mod-L core
// (modl_variants.cu's plan_vecs), the halves by 16-byte loads or, with
// SCALAR_LOADS, by v12's 8-byte loads.
template <int PLAN, bool SCALAR_LOADS>
ED_FN void var_sha512_modl_lane(const int64_t* wh, const int64_t* wl, int n_blocks,
                                modl_vec* out) {
    modl_vec d[4], r[2];
    if (SCALAR_LOADS) {
        uint64_t st[8];
        v12_sha512_state(st, wh, wl, n_blocks);
#pragma unroll
        for (int k = 0; k < 4; k++)
            d[k] = modl_vec{sha512_bswap32((uint32_t)(st[2 * k] >> 32)),
                            sha512_bswap32((uint32_t)st[2 * k]),
                            sha512_bswap32((uint32_t)(st[2 * k + 1] >> 32)),
                            sha512_bswap32((uint32_t)st[2 * k + 1])};
    } else {
        sha512_digest(wh, wl, n_blocks, d);
    }
    plan_vecs<PLAN>(d, r);
    out[0] = r[0];
    out[1] = r[1];
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) v12_sha512_modl_kernel(int n, int n_blocks,
                                                              const int64_t* __restrict__ wh,
                                                              const int64_t* __restrict__ wl,
                                                              uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    v12_sha512_modl_lane(wh + off, wl + off, n_blocks, out + 32 * (size_t)lane);
}

__global__ void __launch_bounds__(128) v12_sha512_kernel(int n, int n_blocks,
                                                         const int64_t* __restrict__ wh,
                                                         const int64_t* __restrict__ wl,
                                                         uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    v12_sha512_lane(wh + off, wl + off, n_blocks, out + 64 * (size_t)lane);
}

template <int PLAN, bool SCALAR_LOADS>
__global__ void __launch_bounds__(128) var_sha512_modl_kernel(int n, int n_blocks,
                                                              const int64_t* __restrict__ wh,
                                                              const int64_t* __restrict__ wl,
                                                              modl_vec* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const size_t off = (size_t)lane * n_blocks * 16;
    var_sha512_modl_lane<PLAN, SCALAR_LOADS>(wh + off, wl + off, n_blocks, out + 2 * (size_t)lane);
}

__global__ void sha512_block_probe(const ulonglong2* __restrict__ in,
                                   ulonglong2* __restrict__ out) {
    const size_t lane = blockIdx.x * blockDim.x + threadIdx.x;
    uint64_t st[8], w[16];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const ulonglong2 a = in[12 * lane + k];
        st[2 * k] = a.x;
        st[2 * k + 1] = a.y;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const ulonglong2 a = in[12 * lane + 4 + k];
        w[2 * k] = a.x;
        w[2 * k + 1] = a.y;
    }
    sha512_block(st, w);
#pragma unroll
    for (int k = 0; k < 4; k++) out[4 * lane + k] = ulonglong2{st[2 * k], st[2 * k + 1]};
}

extern "C" int ba_sha512_modl_variant(int variant, int n, int n_blocks, const void* wh,
                                      const void* wl, void* out, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
        case 0:
            v12_sha512_modl_kernel<<<(n + 127) / 128, 128, 0, s>>>(
                n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (uint8_t*)out);
            break;
        case 1:
            var_sha512_modl_kernel<1, false><<<(n + 127) / 128, 128, 0, s>>>(
                n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (modl_vec*)out);
            break;
        case 2:
            var_sha512_modl_kernel<0, true><<<(n + 127) / 128, 128, 0, s>>>(
                n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (modl_vec*)out);
            break;
        default:
            return -1;
    }
    return (int)cudaGetLastError();
}

extern "C" int ba_sha512_variant(int variant, int n, int n_blocks, const void* wh,
                                 const void* wl, void* out, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
        case 0:
            v12_sha512_kernel<<<(n + 127) / 128, 128, 0, s>>>(
                n, n_blocks, (const int64_t*)wh, (const int64_t*)wl, (uint8_t*)out);
            break;
        default:
            return -1;
    }
    return (int)cudaGetLastError();
}

#endif
