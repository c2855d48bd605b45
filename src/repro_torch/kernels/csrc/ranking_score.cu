// Eq.-16 ranking kernels for Hopper (sm_90a): scores plus the masked victim
// selection of the delayed-hit simulator's commit step.
//
// Replaces the Pallas kernels of src/repro/kernels/ranking_score.py:
//   rank_select_scores + merge_candidates(top)  <- _rank_select_kernel
//                                                  (ranking_victim_order)
//   rank_select_scores + merge_candidates(1)    <- _rank_kernel
//                                                  (ranking_scores)
//
// What bounds it on this card: memory.  Per element it reads four f32
// streams (lam, z, resid, sizes) and one bool (cached), writes one f32
// score, and does about 15 flops and one sqrt: 21 bytes against ~15
// operations, far below the H100's ~20 flops/byte balance point.  At
// N = 2^20 the bound is ~22 MB / 3.35 TB/s ~ 6.6 us.
//
// Design: one pass over the inputs.  Each CTA of 256 threads owns a tile of
// 1024 consecutive elements (4 per thread, strided by 256 so every load is
// coalesced), computes and stores the scores, and keeps the masked keys in
// registers.  It then runs `top` rounds of a (value, index) argmin over the
// tile: warp butterflies with __shfl_xor_sync, then one pass over the 8
// warp winners in shared memory.  Round r takes the least key strictly
// greater than round r-1's winner in (value, index) order, so no element is
// ever marked or rewritten and the tile is read from memory exactly once.
// The TPU kernel ran its grid in order on one core and left the merge to
// XLA; here the CTAs run in parallel, and a second one-CTA kernel merges the
// grid * top block candidates with the same reduction.
//
// Keys: a score counts only where the object is cached and the score is
// below 3.4e38; every other element has key +inf (judged by value, never by
// index).  Ties always go to the lower index, and +inf keys are ordered by
// index too, so the victim order is exactly the first `top` entries of a
// stable ascending sort of the masked scores.  Elements past N carry the
// phantom key (+inf, INT_MAX), which sorts after every real element.
//
// Build with --fmad=false and without --use_fast_math: every product and
// sum below then rounds once, in the order written, like the plain PyTorch
// version (repro_torch/kernels/ref.py), so the scores agree bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;   // 1024
constexpr int kMergeThreads = 1024;
constexpr int kPhantom = 0x7fffffff;
constexpr float kSentinel = 3.4e38f;

struct Key {
    float v;
    int i;
};

__device__ __forceinline__ bool key_less(Key a, Key b) {
    return a.v < b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ Key key_min(Key a, Key b) {
    return key_less(b, a) ? b : a;
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return x < lo ? lo : x;      // NaN passes through, as torch.clamp
}

__device__ __forceinline__ float eq16(float lam, float z, float r, float s,
                                      float omega) {
    float z2 = z * z;
    float e = z + lam * z2;
    float var = z2 + 6.0f * lam * z2 * z + 5.0f * lam * lam * z2 * z2;
    return (e + omega * sqrtf(var)) /
           (clamp_min(r, 1e-6f) * clamp_min(s, 1e-6f));
}

// Block-wide (value, index) argmin; every thread returns the winner.
// `warp_best` is shared scratch of one Key per warp.
__device__ Key block_argmin(Key k, Key* warp_best) {
    for (int off = 16; off > 0; off >>= 1) {
        Key o;
        o.v = __shfl_xor_sync(0xffffffffu, k.v, off);
        o.i = __shfl_xor_sync(0xffffffffu, k.i, off);
        k = key_min(k, o);
    }
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_best[warp] = k;
    __syncthreads();
    Key best = warp_best[0];
    for (int w = 1; w < n_warps; ++w) best = key_min(best, warp_best[w]);
    __syncthreads();             // warp_best is reused by the next round
    return best;
}

__global__ void __launch_bounds__(kThreads)
rank_select_scores_kernel(const float* __restrict__ lam,
                          const float* __restrict__ z,
                          const float* __restrict__ resid,
                          const float* __restrict__ sizes,
                          const uint8_t* __restrict__ cached,
                          float omega, int64_t n, int top,
                          float* __restrict__ scores,
                          float* __restrict__ cand_v,
                          int* __restrict__ cand_i) {
    __shared__ Key warp_best[kThreads / 32];
    const int64_t base = (int64_t)blockIdx.x * kTile;
    Key keys[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int64_t e = base + k * kThreads + threadIdx.x;
        if (e < n) {
            const float f = eq16(lam[e], z[e], resid[e], sizes[e], omega);
            scores[e] = f;
            keys[k].v = (cached[e] && f < kSentinel) ? f : INFINITY;
            keys[k].i = (int)e;
        } else {
            keys[k].v = INFINITY;
            keys[k].i = kPhantom;
        }
    }
    Key prev = {-INFINITY, -1};
    for (int r = 0; r < top; ++r) {
        Key mine = {INFINITY, kPhantom};
#pragma unroll
        for (int k = 0; k < kPerThread; ++k)
            if (key_less(prev, keys[k])) mine = key_min(mine, keys[k]);
        prev = block_argmin(mine, warp_best);
        if (threadIdx.x == 0) {
            cand_v[(int64_t)blockIdx.x * top + r] = prev.v;
            cand_i[(int64_t)blockIdx.x * top + r] = prev.i;
        }
    }
}

// One CTA: the `top` least candidates in (value, index) order.
__global__ void __launch_bounds__(kMergeThreads)
merge_candidates_kernel(const float* __restrict__ cand_v,
                        const int* __restrict__ cand_i, int64_t m, int top,
                        float* __restrict__ out_v, int* __restrict__ out_i) {
    __shared__ Key warp_best[kMergeThreads / 32];
    Key prev = {-INFINITY, -1};
    for (int r = 0; r < top; ++r) {
        Key mine = {INFINITY, kPhantom};
        for (int64_t c = threadIdx.x; c < m; c += blockDim.x) {
            Key k = {cand_v[c], cand_i[c]};
            if (key_less(prev, k)) mine = key_min(mine, k);
        }
        prev = block_argmin(mine, warp_best);
        if (threadIdx.x == 0) {
            out_v[r] = prev.v;
            out_i[r] = prev.i;
        }
    }
}

}  // namespace

extern "C" {

// Scores for all n elements plus `top` candidates per 1024-element tile:
// cand_v/cand_i hold ceil(n / 1024) * top entries.
int rank_select_scores(const void* lam, const void* z, const void* resid,
                       const void* sizes, const void* cached, float omega,
                       int64_t n, int top, void* scores, void* cand_v,
                       void* cand_i, void* stream) {
    const int64_t grid = (n + kTile - 1) / kTile;
    rank_select_scores_kernel<<<(unsigned)grid, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)lam, (const float*)z, (const float*)resid,
        (const float*)sizes, (const uint8_t*)cached, omega, n, top,
        (float*)scores, (float*)cand_v, (int*)cand_i);
    return (int)cudaGetLastError();
}

// The `top` least of m candidates, ascending in (value, index).
int merge_candidates(const void* cand_v, const void* cand_i, int64_t m,
                     int top, void* out_v, void* out_i, void* stream) {
    merge_candidates_kernel<<<1, kMergeThreads, 0, (cudaStream_t)stream>>>(
        (const float*)cand_v, (const int*)cand_i, m, top, (float*)out_v,
        (int*)out_i);
    return (int)cudaGetLastError();
}

}  // extern "C"
