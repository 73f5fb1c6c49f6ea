// K6's designs beside the shipped one (ba_tpu_torch/ops/csrc/modl.cu), for
// scripts/k6k5_variants.py: a variant number a launch of
// ba_modl_variant, each output held bit-equal to the shipped kernel's.
//
//   0  v12: the previous design (modl.cuh before the word form), the
//      TPU kernel's plan carried over: 64 bytes widened into int64 byte
//      limbs, three folds at 2^256 by the byte constants of 16 delta, six
//      sequential byte-carry passes, 64 byte loads and 32 byte stores a
//      lane; 128 threads a block.
//   1  fold: plan (a), the TPU's fold plan on 32-bit words (fold_words:
//      two folds at 2^252 by delta, 36 and 20 word products, each kept
//      non-negative by a multiple of L, then modl.cuh's exact fold), the
//      shipped loads and stores.
//   2  barrett64, 3 barrett256: the shipped core and layout at 64 or 256
//      threads a block (shipped: 128).
//   4  barrett_lanes2: two lanes a thread.
//   5  barrett_smem: the block's 8 KB staged through shared memory by
//      coalesced 16-byte loads (lane-major in the tile, so a thread's reads
//      are conflict-free), the results back the same way.
//   6  barrett_bytes: the shipped core on 64 byte loads and 32 byte stores,
//      v12's memory layout: what the arithmetic alone moves.
//
// The probes, never launched, count in SASS the least work a lane of each
// plan (scripts/k6k5_variants.py): four 16-byte loads, the reduction, two
// 16-byte stores, no bounds check.
//
// Interface: in uint8 [n, 64] -> out uint8 [n, 32], both little endian.

#include "modl.cuh"

// L in little-endian bytes and C16 = 16 delta (2^256 = -C16 mod L).
ED_CONST int32_t V12_MODL_L[32] = {
    237, 211, 245, 92, 26, 99, 18, 88, 214, 156, 247, 162, 222, 249, 222, 20,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 16};
ED_CONST int32_t V12_MODL_C16[17] = {
    208, 62, 93, 207, 165, 49, 38, 129, 101, 205, 121, 47, 234, 157, 239, 77, 1};

ED_FN void v12_carry_seq(int64_t* v, int n) {
    int64_t c = 0;
#pragma unroll
    for (int i = 0; i < n - 1; i++) {
        const int64_t x = v[i] + c;
        c = x >> 8;
        v[i] = x - c * 256;
    }
    v[n - 1] += c;
}

ED_FN void v12_fold256(int64_t* v, int n_in) {
    int64_t hi[32];
    const int nh = n_in - 32;
#pragma unroll
    for (int i = 0; i < 32; i++) hi[i] = i < nh ? v[32 + i] : 0;
#pragma unroll
    for (int i = 32; i < 64; i++) v[i] = 0;
#pragma unroll
    for (int j = 0; j < 17; j++)
#pragma unroll
        for (int i = 0; i < 32; i++)
            if (i < nh) v[j + i] -= V12_MODL_C16[j] * hi[i];
}

ED_FN void v12_modl_core(int64_t v[64], uint8_t out[32]) {
    v12_fold256(v, 64);
    v12_carry_seq(v, 49);
    v12_fold256(v, 49);
    v12_carry_seq(v, 34);
    v12_fold256(v, 34);
    v[32] = 0;
    v[33] = 0;
#pragma unroll
    for (int i = 0; i < 32; i++) v[i] += 4 * V12_MODL_L[i];
    v12_carry_seq(v, 34);
    const int64_t hi = (v[31] >> 4) + v[32] * 16 + v[33] * 4096;
    v[31] &= 0xF;
    v[32] = 0;
#pragma unroll
    for (int j = 0; j < 16; j++) v[j] -= hi * V12_MODL_L[j];
#pragma unroll
    for (int i = 0; i < 32; i++) v[i] += V12_MODL_L[i];
    v12_carry_seq(v, 33);
    int64_t diff[33];
    int64_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 33; i++) {
        const int64_t x = v[i] - (i < 32 ? V12_MODL_L[i] : 0) + borrow;
        borrow = x >> 8;
        diff[i] = x - borrow * 256;
    }
    const bool ge = borrow >= 0;
#pragma unroll
    for (int i = 0; i < 32; i++) out[i] = (uint8_t)(ge ? diff[i] : v[i]);
}

ED_FN void v12_modl_lane(const uint8_t* in, uint8_t* out) {
    int64_t v[64];
#pragma unroll
    for (int i = 0; i < 64; i++) v[i] = in[i];
    v12_modl_core(v, out);
}

// Plan (a): K1 = c1 L with c1 = ceil(2^260 delta / L) (>= any q delta,
// q = x >> 252), K2 = 42 L (>= any h delta, h < 2^133).
ED_CONST uint32_t FOLD_K1[13] = {0x449c0f01, 0xa40611e3, 0x68859347, 0xd00e1ba7, 0x17f5be65,
                                 0xceec73d2, 0x7c309a3d, 0x0399411b, 0xcf5d3ed0, 0x812631a5,
                                 0x2f79cd65, 0x4def9dea, 0x1};
ED_CONST uint32_t FOLD_K2[9] = {0x4054c4e2, 0x73044253, 0xbc9fbb2a, 0x6c94fe86, 0x3,
                                0x0, 0x0, 0xa0000000, 0x2};

// lo + K - h delta (N words): lo the low 252 bits of x, h (NH words) its
// bits from 252 up.
template <int N, int NH>
ED_FN void fold_step(const uint32_t* x, const uint32_t* h, const uint32_t* K, uint32_t* out) {
    uint32_t p[N];
#pragma unroll
    for (int k = 0; k < N; k++) p[k] = 0;
#pragma unroll
    for (int i = 0; i < NH; i++) {
        uint32_t carry = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            const uint64_t t = (uint64_t)h[i] * MODL_DELTA[j] + p[i + j] + carry;
            p[i + j] = (uint32_t)t;
            carry = (uint32_t)(t >> 32);
        }
        p[i + 4] = carry;
    }
    int64_t c = 0;
#pragma unroll
    for (int k = 0; k < N; k++) {
        const int64_t lo = k < 7 ? x[k] : (k == 7 ? (x[7] & 0x0fffffff) : 0);
        const int64_t s = lo + K[k] - (int64_t)p[k] + c;
        out[k] = (uint32_t)s;
        c = s >> 32;
    }
}

ED_FN void fold_words(const uint32_t w[16], uint32_t r[8]) {
    uint32_t q[9], x1[13], h[5], x2[9];
#pragma unroll
    for (int i = 0; i < 8; i++) q[i] = (w[7 + i] >> 28) | (w[8 + i] << 4);
    q[8] = w[15] >> 28;
    fold_step<13, 9>(w, q, FOLD_K1, x1);  // [0, 2^385)
#pragma unroll
    for (int i = 0; i < 5; i++) h[i] = (x1[7 + i] >> 28) | (x1[8 + i] << 4);
    fold_step<9, 5>(x1, h, FOLD_K2, x2);  // [0, 43 L)
    const int64_t t = (x2[7] >> 28) | (x2[8] << 4);
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = x2[i];
    r[7] &= 0x0fffffff;
    modl_finish(r, t);
}

// x -> x mod L by plan PLAN: 0 the shipped Barrett core, 1 the fold plan.
template <int PLAN>
ED_FN void plan_vecs(const modl_vec x[4], modl_vec out[2]) {
    if (PLAN == 0) {
        modl_vecs(x, out);
        return;
    }
    const uint32_t w[16] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y, x[1].z, x[1].w,
                            x[2].x, x[2].y, x[2].z, x[2].w, x[3].x, x[3].y, x[3].z, x[3].w};
    uint32_t r[8];
    fold_words(w, r);
    out[0] = modl_vec{r[0], r[1], r[2], r[3]};
    out[1] = modl_vec{r[4], r[5], r[6], r[7]};
}

#if defined(__CUDACC__)

__global__ void __launch_bounds__(128) v12_modl_kernel(int n, const uint8_t* __restrict__ in,
                                                       uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    v12_modl_lane(in + 64 * (size_t)lane, out + 32 * (size_t)lane);
}

// PLAN's core, LANES lanes a thread, vector loads and stores.
template <int PLAN, int LANES>
__global__ void var_kernel(int n, const modl_vec* __restrict__ in, modl_vec* __restrict__ out) {
    const int first = (blockIdx.x * blockDim.x + threadIdx.x) * LANES;
#pragma unroll
    for (int l = 0; l < LANES; l++) {
        const int lane = first + l;
        if (lane >= n) return;
        modl_vec x[4], r[2];
#pragma unroll
        for (int k = 0; k < 4; k++) x[k] = in[4 * (size_t)lane + k];
        plan_vecs<PLAN>(x, r);
        out[2 * (size_t)lane] = r[0];
        out[2 * (size_t)lane + 1] = r[1];
    }
}

__global__ void __launch_bounds__(128) smem_kernel(int n, const modl_vec* __restrict__ in,
                                                   modl_vec* __restrict__ out) {
    __shared__ modl_vec tile[4 * 128];  // vector k of lane t at k * 128 + t
    const int base = blockIdx.x * 128, t = threadIdx.x;
    const int lanes = min(128, n - base);
    for (int g = t; g < 4 * lanes; g += 128)
        tile[(g & 3) * 128 + (g >> 2)] = in[4 * (size_t)base + g];
    __syncthreads();
    modl_vec x[4], r[2];
    if (t < lanes) {
#pragma unroll
        for (int k = 0; k < 4; k++) x[k] = tile[k * 128 + t];
        modl_vecs(x, r);
    }
    __syncthreads();
    if (t < lanes) {
        tile[2 * t] = r[0];
        tile[2 * t + 1] = r[1];
    }
    __syncthreads();
    for (int g = t; g < 2 * lanes; g += 128) out[2 * (size_t)base + g] = tile[g];
}

__global__ void __launch_bounds__(128) bytes_kernel(int n, const uint8_t* __restrict__ in,
                                                    uint8_t* __restrict__ out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint32_t w[16], r[8];
#pragma unroll
    for (int k = 0; k < 16; k++) {
        const uint8_t* b = in + 64 * (size_t)lane + 4 * k;
        w[k] = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    }
    modl_words(w, r);
#pragma unroll
    for (int k = 0; k < 32; k++)
        out[32 * (size_t)lane + k] = (uint8_t)(r[k >> 2] >> (8 * (k & 3)));
}

template <int PLAN>
__device__ __forceinline__ void probe_lane(const modl_vec* __restrict__ in,
                                           modl_vec* __restrict__ out) {
    const size_t lane = blockIdx.x * blockDim.x + threadIdx.x;
    modl_vec x[4], r[2];
#pragma unroll
    for (int k = 0; k < 4; k++) x[k] = in[4 * lane + k];
    plan_vecs<PLAN>(x, r);
    out[2 * lane] = r[0];
    out[2 * lane + 1] = r[1];
}

__global__ void modl_probe_barrett(const modl_vec* __restrict__ in, modl_vec* __restrict__ out) {
    probe_lane<0>(in, out);
}

__global__ void modl_probe_fold(const modl_vec* __restrict__ in, modl_vec* __restrict__ out) {
    probe_lane<1>(in, out);
}

extern "C" int ba_modl_variant(int variant, int n, const void* in, void* out, void* stream) {
    if (n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (variant) {
        case 0:
            v12_modl_kernel<<<(n + 127) / 128, 128, 0, s>>>(n, (const uint8_t*)in,
                                                             (uint8_t*)out);
            break;
        case 1:
            var_kernel<1, 1><<<(n + 127) / 128, 128, 0, s>>>(n, (const modl_vec*)in,
                                                             (modl_vec*)out);
            break;
        case 2:
            var_kernel<0, 1><<<(n + 63) / 64, 64, 0, s>>>(n, (const modl_vec*)in,
                                                           (modl_vec*)out);
            break;
        case 3:
            var_kernel<0, 1><<<(n + 255) / 256, 256, 0, s>>>(n, (const modl_vec*)in,
                                                             (modl_vec*)out);
            break;
        case 4:
            var_kernel<0, 2><<<(n + 255) / 256, 128, 0, s>>>(n, (const modl_vec*)in,
                                                             (modl_vec*)out);
            break;
        case 5:
            smem_kernel<<<(n + 127) / 128, 128, 0, s>>>(n, (const modl_vec*)in, (modl_vec*)out);
            break;
        case 6:
            bytes_kernel<<<(n + 127) / 128, 128, 0, s>>>(n, (const uint8_t*)in, (uint8_t*)out);
            break;
        default:
            return -1;
    }
    return (int)cudaGetLastError();
}

#endif
