// K8's variants for scripts/k9k8_variants.py, against the shipped
// ed25519_field.cuh and safegcd.cuh (ba_tpu_torch/ops/csrc), each the
// function of ba_tpu_torch/ops/csrc/powchain.cu's compress_kernel (uint8
// [n, 4, 32] -> [n, 32], bit-equal):
// - chain: 1/Z by the 2^k - 1 chain (fe_inv_chain), one thread a lane: the
//   previous design;
// - safegcd: 1/Z by Bernstein-Yang divsteps (fe_inv_safegcd), one thread a
//   lane: the shipped design;
// - pair: the chain with two threads a lane.  Each multiply and squaring
//   is split by output column: thread p of a pair makes the wrapped columns
//   2m + p (m = 0..4), 50 of the 100 products, with g rotated by p so the
//   indices stay compile-time; the pair swaps its five int64 columns by
//   shuffles and both carry all ten (the same values as fe_mul's).
// Each at 32- or 64-thread blocks (threads, for the pair).

#include "ed25519_field.cuh"
#include "safegcd.cuh"

// h = f g, computed by the two threads of a pair in step (p = lane & 1);
// both end with the whole carried h.
__device__ __forceinline__ void fe_mul_pair(fe& h, const fe& f, const fe& g) {
    const int p = threadIdx.x & 1;
    int32_t fs[10], gr[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        fs[i] = ((i & 1) && p == 0) ? 2 * f.v[i] : f.v[i];  // odd i meets odd j only at p = 0
        gr[i] = p ? g.v[(i + 1) % 10] : g.v[i];
    }
    int64_t own[5];
#pragma unroll
    for (int m = 0; m < 5; m++) {
        int64_t lo = 0, hi = 0, mid = 0;
#pragma unroll
        for (int i = 0; i < 10; i++) {
            const int64_t prod = (int64_t)fs[i] * gr[(2 * m - i + 10) % 10];
            if (i <= 2 * m)
                lo += prod;
            else if (i == 2 * m + 1)
                mid = prod;  // wraps (x 19) only in column 2m, not in 2m + 1
            else
                hi += prod;
        }
        own[m] = lo + 19 * hi + (p ? mid : 19 * mid);
    }
    int64_t t[10];
#pragma unroll
    for (int m = 0; m < 5; m++) {
        const int64_t other = __shfl_xor_sync(0xFFFFFFFFu, own[m], 1);
        t[2 * m] = p ? other : own[m];
        t[2 * m + 1] = p ? own[m] : other;
    }
    fe_reduce64(h, t);
}

__device__ __forceinline__ void fe_sq_n_pair(fe& h, const fe& f, int n) {
    h = f;
#pragma unroll 1
    for (int i = 0; i < n; i++) fe_mul_pair(h, h, h);
}

__device__ __forceinline__ void fe_inv_chain_pair(fe& out, const fe& z) {
    fe z2, z11, t, t2, t4, t5, t10, t20, t40, t50, t100, s;
    fe_mul_pair(z2, z, z);
    fe_sq_n_pair(t, z2, 2);
    fe_mul_pair(t, t, z);
    fe_mul_pair(z11, t, z2);
    fe_sq_n_pair(s, z, 1);     fe_mul_pair(t2, s, z);
    fe_sq_n_pair(s, t2, 2);    fe_mul_pair(t4, s, t2);
    fe_sq_n_pair(s, t4, 1);    fe_mul_pair(t5, s, z);
    fe_sq_n_pair(s, t5, 5);    fe_mul_pair(t10, s, t5);
    fe_sq_n_pair(s, t10, 10);  fe_mul_pair(t20, s, t10);
    fe_sq_n_pair(s, t20, 20);  fe_mul_pair(t40, s, t20);
    fe_sq_n_pair(s, t40, 10);  fe_mul_pair(t50, s, t10);
    fe_sq_n_pair(s, t50, 50);  fe_mul_pair(t100, s, t50);
    fe_sq_n_pair(s, t100, 100); fe_mul_pair(s, s, t100);
    fe_sq_n_pair(s, s, 50);    fe_mul_pair(t, s, t50);
    fe_sq_n_pair(t, t, 5);
    fe_mul_pair(out, t, z11);
}

template <int INV>  // 0 the chain, 1 safegcd
__device__ __forceinline__ void compress_one(const uint8_t* pt, uint8_t* enc) {
    fe x, y, z, zi;
    fe_frombytes(x, pt);
    fe_frombytes(y, pt + 32);
    fe_frombytes(z, pt + 64);
    if (INV == 0)
        fe_inv_chain(zi, z);
    else
        fe_inv_safegcd(zi, z);
    fe_mul(x, x, zi);
    fe_mul(y, y, zi);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    fe_tobytes(enc, y);
    enc[31] |= (uint8_t)((xb[0] & 1) << 7);
}

template <int INV, int BLOCK>
__global__ void __launch_bounds__(BLOCK) lane_kernel(int n, const uint8_t* __restrict__ pts,
                                                     uint8_t* __restrict__ enc) {
    const int lane = blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;
    compress_one<INV>(pts + 128 * (size_t)lane, enc + 32 * (size_t)lane);
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK) pair_kernel(int n, const uint8_t* __restrict__ pts,
                                                     uint8_t* __restrict__ enc) {
    const int lane = (blockIdx.x * BLOCK + threadIdx.x) / 2;
    const int at = lane < n ? lane : n - 1;  // every pair runs: the shuffles need both
    const uint8_t* pt = pts + 128 * (size_t)at;
    fe x, y, z, zi;
    fe_frombytes(x, pt);
    fe_frombytes(y, pt + 32);
    fe_frombytes(z, pt + 64);
    fe_inv_chain_pair(zi, z);
    fe_mul_pair(x, x, zi);
    fe_mul_pair(y, y, zi);
    if (lane < n && (threadIdx.x & 1) == 0) {
        uint8_t xb[32];
        uint8_t* out = enc + 32 * (size_t)lane;
        fe_tobytes(xb, x);
        fe_tobytes(out, y);
        out[31] |= (uint8_t)((xb[0] & 1) << 7);
    }
}

// Not a variant: the least work a lane of the function needs, for K8's
// bound (k9k8_variants.py counts its SASS; it computes no encoding of its
// own).  1/Z over n lanes by Montgomery's batch inversion is one inversion
// a launch and three multiplies a lane: the prefix product on the way out,
// and on the way back the lane's inverse (the suffix's inverse times the
// prefix before the lane) and the next suffix's inverse.  Z = 0 mod p is
// masked to 1 and its inverse to 0 (frombytes leaves limbs in [0, 2^b), so
// Z = 0 mod p is all limbs 0 or p's own limbs); then x = X/Z, y = Y/Z, their
// canonical forms and the encoding.  acc holds a lane's prefix before it,
// the inverse through it and the two results, as the two passes would.
__global__ void __launch_bounds__(32) batch_lane_probe(int n, const uint8_t* __restrict__ pts,
                                                       int32_t* __restrict__ acc,
                                                       uint8_t* __restrict__ enc) {
    const int lane = blockIdx.x * 32 + threadIdx.x;
    if (lane >= n) return;
    const uint8_t* pt = pts + 128 * (size_t)lane;
    int32_t* a = acc + 40 * (size_t)lane;
    fe x, y, z, one, prev, inv, prefix, zi, next;
    fe_frombytes(x, pt);
    fe_frombytes(y, pt + 32);
    fe_frombytes(z, pt + 64);
    bool zero = true, is_p = true;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        zero = zero && z.v[i] == 0;
        is_p = is_p && z.v[i] == (1 << FE_B(i)) - (i == 0 ? 19 : 1);
    }
    const bool z0 = zero || is_p;
    fe_1(one);
    fe_select(z, one, z, z0);
    fe_load(prev, a);
    fe_load(inv, a + 10);
    fe_mul(prefix, prev, z);
    fe_mul(zi, inv, prev);
    fe_mul(next, inv, z);
#pragma unroll
    for (int i = 0; i < 10; i++) {
        a[20 + i] = prefix.v[i];
        a[30 + i] = next.v[i];
        zi.v[i] = z0 ? 0 : zi.v[i];
    }
    fe_mul(x, x, zi);
    fe_mul(y, y, zi);
    uint8_t xb[32];
    uint8_t* out = enc + 32 * (size_t)lane;
    fe_tobytes(xb, x);
    fe_tobytes(out, y);
    out[31] |= (uint8_t)((xb[0] & 1) << 7);
}

// variant: 0 chain / 64, 1 chain / 32, 2 safegcd / 32, 3 safegcd / 64,
// 4 pair / 64 threads, 5 pair / 32 threads.
extern "C" int ba_compress_variant(int variant, int n, const void* pts, void* enc, void* stream) {
    if (n <= 0) return 0;
    const auto* p = (const uint8_t*)pts;
    auto* e = (uint8_t*)enc;
    const auto st = (cudaStream_t)stream;
    switch (variant) {
        case 0: lane_kernel<0, 64><<<(n + 63) / 64, 64, 0, st>>>(n, p, e); break;
        case 1: lane_kernel<0, 32><<<(n + 31) / 32, 32, 0, st>>>(n, p, e); break;
        case 2: lane_kernel<1, 32><<<(n + 31) / 32, 32, 0, st>>>(n, p, e); break;
        case 3: lane_kernel<1, 64><<<(n + 63) / 64, 64, 0, st>>>(n, p, e); break;
        case 4: pair_kernel<64><<<(2 * n + 63) / 64, 64, 0, st>>>(n, p, e); break;
        case 5: pair_kernel<32><<<(2 * n + 31) / 32, 32, 0, st>>>(n, p, e); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
